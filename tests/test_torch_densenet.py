"""DenseNet of the port against the JAX package's, weights bridged by
``weights.py`` with ``load_state_dict(strict=True)``.

``densenet_micro`` (two blocks of two layers, growth 8) at 64 px. The JAX
model is initialised from a PRNG key; BatchNorm parameters and running
statistics are then drawn from a numpy seed so that folding has something to
fold.

- fp32: ``forward`` (eval) and ``fold`` + ``apply_folded`` against the JAX
  model's ``apply`` and ``apply_folded``: atol 2e-4, rtol 1e-4 on logits
  divided by their largest magnitude.
- bf16: the top-1 class agrees with the fp32 reference on every image, and the
  port's largest logit deviation from it is at most twice the JAX model's own
  bf16-vs-fp32 gap on the same input.
- Full width, built on ``meta``: the parameter counts of the reference's
  docstrings, and the reference's channel bookkeeping.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models import densenet as jax_densenet
from ics_tpu_torch import weights
from ics_tpu_torch.models import densenet as torch_densenet
from ics_tpu_torch.nn.layers import avg_pool


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
    jmodel = jax_densenet.densenet_micro(num_classes=10)
    variables = _randomise_batchnorm(
        jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        np.random.default_rng(5))
    tmodel = torch_densenet.densenet_micro(num_classes=10)
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
    layer = variables["params"]["stages"][1][1]
    np.testing.assert_array_equal(
        sd["stages.1.1.conv2.weight"].numpy(), layer["conv2"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["stages.1.1.bn1.weight"].numpy(), layer["bn1"]["gamma"])
    np.testing.assert_array_equal(
        sd["down.0.bn.running_var"].numpy(), variables["state"]["down"][0]["bn"]["var"])
    np.testing.assert_array_equal(
        sd["final_bn.running_mean"].numpy(), variables["state"]["final_bn"]["mean"])
    np.testing.assert_array_equal(sd["final_bn.bias"].numpy(),
                                  variables["params"]["final_bn"]["beta"])
    assert "stages.0.0.conv1.bias" not in sd            # the convolutions carry no bias


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
        folded = copy.deepcopy(tmodel).fold().to(torch.bfloat16)
        # the pre-activation pairs follow the cast, as the JAX engine's leaves do
        assert folded.stages[0][0].bn1.scale.dtype == torch.bfloat16
        out = folded.apply_folded(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
    jax_gap = np.abs(jax_bf16 - ref).max()
    assert np.abs(out - ref).max() <= 2 * jax_gap, (np.abs(out - ref).max(), jax_gap)


def test_fold_keeps_each_pre_activation_bn_as_its_pair(pair):
    jmodel, variables, tmodel, _ = pair
    jfold = jmodel.fold(variables)
    tmodel.fold()
    for got, ref in ((tmodel.stages[1][0].bn2, jfold["stages"][1][0]["bn2"]),
                     (tmodel.down[0].bn, jfold["down"][0]["bn"]),
                     (tmodel.final_bn, jfold["final_bn"])):
        assert got.scale.dtype == got.shift.dtype == torch.float32
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref["scale"]), rtol=1e-6)
        np.testing.assert_allclose(got.shift.numpy(), np.asarray(ref["bias"]),
                                   rtol=1e-6, atol=1e-7)
    assert tmodel.stem.scale is not None                 # conv then BN: folded into the conv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(7, 9), (8, 8), (15, 6), (3, 5)])
def test_avg_pool_matches_the_reference_at_odd_sizes(hw, dtype):
    from ics_tpu.nn.layers import avg_pool as jax_avg_pool

    x = np.random.default_rng(sum(hw)).standard_normal((2, *hw, 5)).astype(np.float32)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(jax_avg_pool(jnp.asarray(x, jdtype), 2, 2).astype(jnp.float32))
    got = avg_pool(torch.from_numpy(x).to(dtype), 2, 2)
    assert got.dtype == dtype
    assert got.shape == (2, hw[0] // 2, hw[1] // 2, 5)
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("name,count", [("densenet121", 7_978_856),
                                        ("densenet169", 14_149_480)])
def test_full_width_parameter_counts_equal_the_reference(name, count):
    model = getattr(torch_densenet, name)(num_classes=1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == count
    assert not getattr(model, "can_fuse_chains", False)     # TPU_FUSED_CHAINS leaves it alone
    assert str(getattr(jax_densenet, name).__doc__).count(f"{count:,}") == 1


def test_channel_growth_and_transitions():
    m = torch_densenet.densenet121(num_classes=10, device="meta")
    assert [len(st) for st in m.stages] == [6, 12, 24, 16]
    assert m.out_ch == 1024
    # transition inputs 64 + 6 * 32, 128 + 12 * 32, 256 + 24 * 32
    assert [t.bn.weight.shape[0] for t in m.down] == [256, 512, 1024]
    assert not any(getattr(c, "depthwise", False) for c in m.modules())


def test_micro_training_mode_moves_the_running_statistics(pair):
    _, _, tmodel, x = pair
    before = tmodel.final_bn.running_mean.clone()
    tmodel.train()
    try:
        with torch.no_grad():
            tmodel(torch.from_numpy(x[:2]))
    finally:
        tmodel.eval()
    assert not torch.allclose(before, tmodel.final_bn.running_mean)
