"""RegNet-Y of the port against the JAX package's, weights bridged by
``weights.py`` with ``load_state_dict(strict=True)``.

``regnet_micro`` (two stages, group width 8) at 64 px. The JAX model is
initialised from a PRNG key; BatchNorm parameters and running statistics are
then drawn from a numpy seed so that folding has something to fold.

- fp32: ``forward`` (eval) and ``fold`` + ``apply_folded`` against the JAX
  model's ``apply`` and ``apply_folded``: atol 2e-4, rtol 1e-4 on logits
  divided by their largest magnitude.
- bf16: the top-1 class agrees with the fp32 reference on every image, and the
  port's largest logit deviation from it is at most twice the JAX model's own
  bf16-vs-fp32 gap on the same input.
- Full width, built on ``meta``: the parameter counts of the reference's
  docstrings; the grouped 3x3s are never taken for the depthwise kernel.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models import regnet as jax_regnet
from ics_tpu_torch import weights
from ics_tpu_torch.models import regnet as torch_regnet


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
    jmodel = jax_regnet.regnet_micro(num_classes=10)
    variables = _randomise_batchnorm(
        jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        np.random.default_rng(5))
    tmodel = torch_regnet.regnet_micro(num_classes=10)
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
    blk = variables["params"]["stages"][1][0]
    np.testing.assert_array_equal(
        sd["stages.1.0.b.conv.weight"].numpy(), blk["b"]["conv"]["w"].transpose(3, 2, 0, 1))
    assert tuple(sd["stages.1.0.b.conv.weight"].shape) == (32, 8, 3, 3)   # 4 groups of 8
    np.testing.assert_array_equal(sd["stages.1.0.se.fc2.weight"].numpy(), blk["se"]["fc2"]["w"].T)
    np.testing.assert_array_equal(
        sd["stages.1.0.proj.bn.running_var"].numpy(),
        variables["state"]["stages"][1][0]["proj"]["bn"]["var"])
    # the squeeze is round(0.25 * w_in), not of w_b: 16 in -> 4
    assert tuple(sd["stages.1.0.se.fc1.weight"].shape) == (4, 32)


def test_forward_and_folded_match_jax_fp32(pair):
    jmodel, variables, tmodel, x = pair
    ref, _ = jmodel.apply(variables, jnp.asarray(x), training=False)
    ref_folded = jmodel.apply_folded(jmodel.fold(variables), jnp.asarray(x))
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(x)).numpy()
        out_folded = copy.deepcopy(tmodel).fold().apply_folded(torch.from_numpy(x)).numpy()
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
        folded = copy.deepcopy(tmodel).fold().to(torch.bfloat16)
        out = folded.apply_folded(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
    jax_gap = np.abs(jax_bf16 - ref).max()
    assert np.abs(out - ref).max() <= 2 * jax_gap, (np.abs(out - ref).max(), jax_gap)


def test_every_stage_opens_at_stride_2(pair):
    _, _, tmodel, _ = pair
    folded = copy.deepcopy(tmodel).fold()
    with torch.inference_mode():
        y = torch.relu(folded.stem.apply_folded(torch.zeros(1, 64, 64, 3)))
        assert y.shape == (1, 32, 32, 32)                # the stem is always 32 wide
        for blocks in folded.stages:
            for blk in blocks:
                y = blk.apply_folded(y)
    assert y.shape[1:3] == (8, 8)


@pytest.mark.parametrize("name,count", [("regnet_y_400mf", 4_344_144),
                                        ("regnet_y_1_6gf", 11_202_430)])
def test_full_width_parameter_counts_equal_the_reference(name, count):
    model = getattr(torch_regnet, name)(num_classes=1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == count
    assert not getattr(model, "can_fuse_chains", False)     # TPU_FUSED_CHAINS leaves it alone
    assert str(getattr(jax_regnet, name).__doc__).count(f"{count:,}") == 1


@pytest.mark.parametrize("name", ["regnet_y_400mf", "regnet_y_1_6gf", "regnet_micro"])
def test_grouped_convs_are_never_taken_for_the_depthwise_kernel(name):
    model = getattr(torch_regnet, name)(num_classes=10, device="meta")
    ref = getattr(jax_regnet, name)(num_classes=10)
    for blocks, ref_blocks in zip(model.stages, ref.stages):
        for blk, rblk in zip(blocks, ref_blocks):
            conv = blk.b.conv
            assert conv.groups == rblk.b.conv.groups > 1
            assert conv.groups != conv.weight.shape[0]       # groups != in_ch
            assert not conv.depthwise
            assert (blk.proj is None) == (rblk.proj is None)
    assert not any(getattr(m, "depthwise", False) for m in model.modules())


def test_micro_training_mode_moves_the_running_statistics(pair):
    _, _, tmodel, x = pair
    model = copy.deepcopy(tmodel)
    before = model.stem.bn.running_mean.clone()
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x[:2]))
    assert not torch.allclose(before, model.stem.bn.running_mean)
