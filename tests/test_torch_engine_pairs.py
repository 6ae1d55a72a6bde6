"""Engines of the JAX package and of the port on the same weights, for the
serving-extras tests (TTA, explain, trained versions, routes), and a test
of the registrations they lean on.

``engine_pair(name, ...)`` builds a JAX ``InferenceEngine`` from a variables
tree initialised from a PRNG key and randomised with a numpy seed (layer
scales and norm gains in [0.5, 1.5], biases N(0, 0.1), Swin's table
N(0, 0.5), so that every branch, and the kernels in it, reaches the
logits), and a port engine on the CPU from the same tree through
``weights.py``. ``dev_models`` registers ``convnext_dev`` (one block a stage,
dims 16-128, at 64 px), ``densenet_micro`` and ``regnet_micro`` (the
families' dev models, at 64 px) and ``vit_d128_micro`` (the head_dim-128
ViTs cut to two blocks of two heads of 128 at 64 px, tanh GELU) in both
registries, and in the port's ``resnet_2211``, a ResNet whose first two
stages have an identity bottleneck for ``fold(fused_chains=True)`` to chain.
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np

from ics_tpu_torch import weights

DEV_DEPTHS, DEV_DIMS = (1, 1, 1, 1), (16, 32, 64, 128)
# vit_b16_h6d128 / vit_l16_h8d128 cut to size: head_dim 128, tanh GELU in every dtype
VIT_D128_MICRO = dict(image_size=64, patch_size=8, dim=256, depth=2, num_heads=2,
                      gelu_exact=False)


def randomise(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: randomise(v, rng, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [randomise(v, rng, path + (i,)) for i, v in enumerate(tree)]
    if path and path[-1] == "gamma":
        return rng.uniform(0.5, 1.5, tree.shape).astype(np.float32)
    if path and path[-1] in ("b", "beta"):
        return rng.normal(0, 0.1, tree.shape).astype(np.float32)
    if path and path[-1] == "rel_bias":
        return rng.normal(0, 0.5, tree.shape).astype(np.float32)
    return np.asarray(tree)


@contextlib.contextmanager
def dev_models():
    """``convnext_dev``, ``densenet_micro``, ``regnet_micro`` and
    ``vit_d128_micro`` in the JAX registry and the port's, ``resnet_2211`` in
    the port's, at 64 px."""
    import ics_tpu.models.registry as jax_registry
    import ics_tpu_torch.models.registry as torch_registry
    from ics_tpu.models import convnext as jax_convnext
    from ics_tpu.models import densenet as jax_densenet
    from ics_tpu.models import regnet as jax_regnet
    from ics_tpu.models import vit as jax_vit
    from ics_tpu_torch.models import convnext as torch_convnext
    from ics_tpu_torch.models import densenet as torch_densenet
    from ics_tpu_torch.models import regnet as torch_regnet
    from ics_tpu_torch.models import resnet as torch_resnet
    from ics_tpu_torch.models import vit as torch_vit

    jax_registry.get_model("resnet_tiny")          # the registry fills itself on first use
    jax_registry.register_model(
        "convnext_dev", lambda num_classes: jax_convnext.ConvNeXt(
            DEV_DEPTHS, DEV_DIMS, num_classes=num_classes), 64, 64, dev_only=True)
    torch_registry._REGISTRY["convnext_dev"] = torch_registry.ModelSpec(
        "convnext_dev", lambda num_classes, device=None: torch_convnext.ConvNeXt(
            DEV_DEPTHS, DEV_DIMS, num_classes, device=device), 64, 64, dev_only=True)
    torch_registry._REGISTRY["resnet_2211"] = torch_registry.ModelSpec(
        "resnet_2211", lambda num_classes, device=None: torch_resnet.ResNet(
            (2, 2, 1, 1), num_classes, device=device), 64, 64, dev_only=True)
    micro = {"densenet_micro": (jax_densenet.densenet_micro, torch_densenet.densenet_micro),
             "regnet_micro": (jax_regnet.regnet_micro, torch_regnet.regnet_micro),
             "vit_d128_micro": (
                 lambda num_classes: jax_vit.ViT(num_classes=num_classes, **VIT_D128_MICRO),
                 lambda num_classes, device=None: torch_vit.ViT(
                     num_classes=num_classes, device=device, **VIT_D128_MICRO))}
    for name, (jax_build, torch_build) in micro.items():
        jax_registry.register_model(name, jax_build, 64, 64, dev_only=True)
        torch_registry._REGISTRY[name] = torch_registry.ModelSpec(
            name, torch_build, 64, 64, dev_only=True)
    try:
        yield
    finally:
        for name in ("convnext_dev", *micro):
            del jax_registry._REGISTRY[name]
            del torch_registry._REGISTRY[name]
        del torch_registry._REGISTRY["resnet_2211"]


def variables_of(name: str, num_classes: int, seed: int = 0) -> dict:
    """The randomised variables tree of registry model ``name``, as numpy."""
    from ics_tpu.models.registry import get_model

    model = get_model(name).build(num_classes=num_classes)
    tree = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    return randomise(tree, np.random.default_rng(seed + 5))


def engine_pair(name: str, num_classes: int = 6, seed: int = 0, **kwargs):
    """(JAX engine, port engine on the CPU) on the same randomised weights;
    fp32, bucket 1 and a 64 px canvas unless ``kwargs`` say otherwise."""
    from ics_tpu.runtime.engine import InferenceEngine as JaxEngine
    from ics_tpu_torch.runtime.engine import InferenceEngine

    kwargs = {"precision": "fp32", "buckets": (1,), "canvas": 64, **kwargs}
    variables = variables_of(name, num_classes, seed)
    jax_kwargs = {k: v for k, v in kwargs.items() if k != "fused_chains"}
    return (JaxEngine(name, num_classes=num_classes, variables=variables, **jax_kwargs),
            InferenceEngine(name, num_classes=num_classes, device="cpu",
                            state_dict=weights.from_jax_variables(variables), **kwargs))


def test_dev_models_register_in_both_registries_and_leave_none_behind():
    import ics_tpu.models.registry as jax_registry
    import ics_tpu_torch.models.registry as torch_registry

    with dev_models():
        jax_spec = jax_registry.get_model("convnext_dev")
        torch_spec = torch_registry.get_model("convnext_dev")
        assert (jax_spec.dev_only, torch_spec.dev_only) == (True, True)
        assert torch_registry.get_model("resnet_2211").dev_only
        state = torch_spec.build(num_classes=3).state_dict()
        assert state["head.weight"].shape[1] == DEV_DIMS[-1]
        for name in ("densenet_micro", "regnet_micro", "vit_d128_micro"):
            assert jax_registry.get_model(name).dev_only and torch_registry.get_model(name).dev_only
            assert torch_registry.get_model(name).build(num_classes=3).num_classes == 3
        vit = torch_registry.get_model("vit_d128_micro").build(num_classes=3, device="meta")
        assert vit.blocks[0].attn.head_dim == 128 and not vit.blocks[0].gelu_exact
    assert not {"convnext_dev", "densenet_micro", "regnet_micro", "vit_d128_micro"} & set(
        jax_registry._REGISTRY)
    assert not {"convnext_dev", "resnet_2211", "densenet_micro", "regnet_micro",
                "vit_d128_micro"} & set(torch_registry._REGISTRY)
