"""ResNet of the port against the JAX package's, weights bridged by
``weights.py`` with ``load_state_dict(strict=True)``.

The JAX model is initialised from a PRNG key; BatchNorm parameters and
running statistics are then drawn from a numpy seed so that folding has
something to fold. Parameters and state cross as numpy arrays and both
forwards see the same seeded NHWC input at 64 px.

- fp32: ``apply`` (eval), and ``fold`` + ``apply_folded`` with fused chains
  off and on, against the JAX model with ``pallas_chains`` off and on (the
  Pallas kernel in interpret mode): atol 2e-4, rtol 1e-4 on logits divided
  by their largest magnitude (the repo's torch-gold bar).
- bf16: the top-1 class agrees with the fp32 reference on every image, and
  the port's largest logit deviation from it is at most twice the JAX
  model's own bf16-vs-fp32 gap on the same input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models import resnet as jax_resnet
from ics_tpu_torch import weights
from ics_tpu_torch.models import resnet as torch_resnet

CONFIGS = {
    "resnet_tiny": dict(block_counts=(1, 1, 1, 1)),
    "resnet_2211": dict(block_counts=(2, 2, 1, 1)),
    "basic_2111": dict(block_counts=(2, 1, 1, 1), basic=True),
}


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
    }.get(path[-1])
    return np.asarray(tree) if draw is None else draw(tree.shape).astype(np.float32)


def _build(cfg, num_classes=10):
    counts = cfg["block_counts"]
    if cfg.get("basic"):
        return (jax_resnet.ResNet(counts, num_classes, block_cls=jax_resnet.BasicBlock),
                torch_resnet.ResNet(counts, num_classes, block_cls=torch_resnet.BasicBlock))
    return jax_resnet.ResNet(counts, num_classes), torch_resnet.ResNet(counts, num_classes)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    jmodel, tmodel = _build(cfg)
    variables = _randomise_batchnorm(
        jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        np.random.default_rng(5))
    state_dict = weights.from_jax_variables(variables)
    tmodel.load_state_dict(state_dict, strict=True)
    x = np.random.default_rng(1).standard_normal((4, 64, 64, 3)).astype(np.float32)
    return cfg, jmodel, variables, tmodel.eval(), x


def _close(out, ref):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-4, rtol=1e-4)


def _chainable(cfg):
    return not cfg.get("basic")


def test_state_dict_carries_params_and_running_statistics(pair):
    cfg, jmodel, variables, tmodel, _ = pair
    sd = tmodel.state_dict()
    shapes = weights.mapped_shapes(variables)
    assert set(shapes) == set(sd)
    assert all(tuple(sd[k].shape) == shapes[k] for k in sd)
    np.testing.assert_array_equal(
        sd["stages.1.0.cbr2.bn.running_var"].numpy(),
        variables["state"]["stages"][1][0]["cbr2"]["bn"]["var"])
    np.testing.assert_array_equal(
        sd["stem.bn.weight"].numpy(), variables["params"]["stem"]["bn"]["gamma"])
    np.testing.assert_array_equal(
        sd["stages.1.0.down.conv.weight"].numpy(),
        variables["params"]["stages"][1][0]["down"]["conv"]["w"].transpose(3, 2, 0, 1))


def test_apply_eval_matches_jax_fp32(pair):
    _, jmodel, variables, tmodel, x = pair
    ref, _ = jmodel.apply(variables, jnp.asarray(x), training=False)
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(x)).numpy()
    assert out.shape == (4, 10)
    _close(out, np.asarray(ref))


@pytest.mark.parametrize("chains", [False, True], ids=["unfused", "fused_chains"])
def test_folded_matches_jax_fp32(pair, chains):
    cfg, jmodel, variables, tmodel, x = pair
    if chains and not _chainable(cfg):
        with pytest.raises(ValueError, match="basic-block"):
            tmodel.fold(fused_chains=True)
        with pytest.raises(ValueError, match="basic-block"):
            jmodel.fold(variables, pallas_chains=True)
        return
    jfolded = jmodel.fold(variables, pallas_chains=chains)
    ref = np.asarray(jmodel.apply_folded(jfolded, jnp.asarray(x)))
    with torch.inference_mode():
        out = tmodel.fold(fused_chains=chains).apply_folded(torch.from_numpy(x)).numpy()
    assert sorted(tmodel.chains) == sorted(jfolded.get("chains", {}))
    _close(out, ref)
    unfolded, _ = jmodel.apply(variables, jnp.asarray(x), training=False)
    # fused chains carry their weights in bf16 (as the JAX fold packs them),
    # so only the unfused fold equals the unfolded model to fp32 rounding
    if not chains:
        _close(out, np.asarray(unfolded))


@pytest.mark.parametrize("chains", [False, True], ids=["unfused", "fused_chains"])
def test_folded_bf16_top1_and_deviation_against_jax(pair, chains):
    cfg, jmodel, variables, tmodel, x = pair
    if chains and not _chainable(cfg):
        with pytest.raises(ValueError, match="basic-block"):
            tmodel.fold(fused_chains=True)
        return
    ref = np.asarray(jmodel.apply_folded(jmodel.fold(variables), jnp.asarray(x)))
    jfolded = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16) if a.dtype == jnp.float32 else a,
        jmodel.fold(variables, pallas_chains=chains))
    jax_bf16 = np.asarray(jmodel.apply_folded(
        jfolded, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.inference_mode():
        model = tmodel.fold(fused_chains=chains).to(torch.bfloat16)
        out = model.apply_folded(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
        tmodel.to(torch.float32)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
    jax_gap = np.abs(jax_bf16 - ref).max()
    assert np.abs(out - ref).max() <= 2 * jax_gap, (np.abs(out - ref).max(), jax_gap)


def test_fold_chains_exactly_stages_0_and_1_of_resnet50():
    """Shapes only (the meta device): the byte rule of the JAX fold chains
    ResNet-50's stage 0 (2 identity blocks, C 256) and stage 1 (3, C 512);
    stage 2 (5 blocks of C 1024) and stage 3 (2 of C 2048) exceed it."""
    model = torch_resnet.resnet50(num_classes=8)
    model.init_weights(torch.Generator().manual_seed(0))
    model.fold(fused_chains=True)
    assert sorted(model.chains) == ["0", "1"]
    assert tuple(model.chains["0"].w1.shape) == (2, 256, 64)
    assert tuple(model.chains["0"].w2.shape) == (2, 576, 64)
    assert tuple(model.chains["1"].w3.shape) == (3, 128, 512)
    assert model.chains["1"].s3.dtype == torch.float32
    assert model.chains["1"].w1.dtype == torch.bfloat16
    assert len(torch_resnet.resnet50().fold().chains) == 0      # default: off


@pytest.mark.parametrize("name,match", [
    ("resnext50_32x4d", "grouped/wide"), ("wide_resnet50_2", "grouped/wide"),
    ("resnet18", "basic-block"), ("resnet34", "basic-block"),
])
def test_fold_fused_chains_refuses_models_without_a_chain_path(name, match):
    model = getattr(torch_resnet, name)(num_classes=4, device="meta")
    with pytest.raises(ValueError, match=match):
        model.fold(fused_chains=True)


@pytest.mark.parametrize("name", [
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnet_tiny",
    "resnext50_32x4d", "wide_resnet50_2",
])
def test_zoo_constructors_map_the_jax_trees_shape_for_shape(name):
    jmodel = getattr(jax_resnet, name)(num_classes=7)
    shapes = weights.mapped_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    tmodel = getattr(torch_resnet, name)(num_classes=7, device="meta")
    sd = tmodel.state_dict()
    assert set(sd) == set(shapes)
    assert all(tuple(sd[k].shape) == shapes[k] for k in sd)


def test_init_weights_draws_the_jax_initialisers_distributions():
    model = torch_resnet.resnet_tiny(num_classes=16).init_weights(
        torch.Generator().manual_seed(0))
    w = model.stages[3][0].cbr2.conv.weight
    assert abs(w.std().item() - (2.0 / (9 * 512)) ** 0.5) < 2e-4
    assert abs(model.head.weight.std().item() - (2.0 / 2048) ** 0.5) < 2e-3
    bn = model.stem.bn
    assert bool((bn.weight == 1).all() and (bn.bias == 0).all()
                and (bn.running_mean == 0).all() and (bn.running_var == 1).all())
