"""ViT of the port against the JAX package's, weights bridged by ``weights.py``.

The JAX model is initialised from a PRNG key, its parameters cross as
numpy arrays, and both forwards see the same seeded NHWC input. Attention
runs in the JAX flash kernel (interpret mode on CPU) and in the port's
plain version (CPU tensors).

- fp32: logits within atol 2e-4, rtol 1e-4 (the repo's torch-gold bar).
- bf16: the top-1 class agrees with the fp32 reference, and the port's
  max|Δlogit| from it is at most twice the JAX package's own bf16-vs-fp32
  gap on the same input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models import vit as jax_vit
from ics_tpu_torch import weights
from ics_tpu_torch.models import vit as torch_vit

CONFIGS = {
    "vit_32px": dict(image_size=32, patch_size=8, dim=64, depth=2, num_heads=2,
                     num_classes=10),
    "vit_tiny": dict(image_size=64, patch_size=8, dim=32, depth=8, num_heads=2,
                     num_classes=10),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    jmodel = jax_vit.ViT(**cfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0))
    )
    tmodel = torch_vit.ViT(**cfg)
    tmodel.load_state_dict(weights.from_jax_variables(variables), strict=True)
    x = np.random.default_rng(1).standard_normal(
        (4, cfg["image_size"], cfg["image_size"], 3)
    ).astype(np.float32)
    return jmodel, variables, tmodel.eval(), x


def _jax_logits(jmodel, variables, x, dtype):
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype), jmodel.fold(variables)
    )
    return np.asarray(
        jmodel.apply_folded(params, jnp.asarray(x, dtype)).astype(jnp.float32)
    )


def _torch_logits(tmodel, x, dtype):
    with torch.inference_mode():
        model = tmodel.to(dtype)
        out = model.apply_folded(torch.from_numpy(x).to(dtype)).float().numpy()
        tmodel.to(torch.float32)
    return out


def test_logits_match_jax_fp32(pair):
    jmodel, variables, tmodel, x = pair
    np.testing.assert_allclose(
        _torch_logits(tmodel, x, torch.float32),
        _jax_logits(jmodel, variables, x, jnp.float32),
        atol=2e-4, rtol=1e-4,
    )


def test_logits_bf16_within_twice_jax_own_gap(pair):
    jmodel, variables, tmodel, x = pair
    ref = _jax_logits(jmodel, variables, x, jnp.float32)
    jax_gap = np.abs(_jax_logits(jmodel, variables, x, jnp.bfloat16) - ref).max()
    ours = _torch_logits(tmodel, x, torch.bfloat16)
    assert np.array_equal(ours.argmax(-1), ref.argmax(-1))
    assert np.abs(ours - ref).max() <= 2 * jax_gap, (np.abs(ours - ref).max(), jax_gap)


def test_plain_attention_path_matches_flash_path(pair):
    _, _, tmodel, x = pair
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        torch.testing.assert_close(tmodel(xt, use_flash=False), tmodel.apply_folded(xt))


def test_vit_b16_full_width_maps_one_to_one():
    """ViT-B/16 @384 at full width, shapes only: every JAX parameter lands on
    exactly one state-dict entry of the same shape, 86.86M parameters."""
    shapes = jax.eval_shape(jax_vit.vit_b16().init, jax.random.PRNGKey(0))
    mapped = weights.mapped_shapes(shapes)
    ours = {k: tuple(v.shape) for k, v in torch_vit.vit_b16(device="meta").state_dict().items()}
    assert mapped == ours
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    n_ours = sum(int(np.prod(s)) for s in ours.values())
    assert n_jax == n_ours == 86_859_496


def test_from_jax_variables_layouts():
    rng = np.random.default_rng(0)
    tree = {"params": {
        "patch_embed": {"w": rng.standard_normal((2, 3, 4, 5)), "b": np.zeros(5)},
        "blocks": [{"fc1": {"w": rng.standard_normal((6, 7)), "b": np.ones(7)},
                    "ln1": {"gamma": np.ones(6), "beta": np.zeros(6)}}],
    }}
    sd = weights.from_jax_variables(tree)
    assert sd["patch_embed.weight"].shape == (5, 4, 2, 3)
    np.testing.assert_array_equal(
        sd["patch_embed.weight"][1, 2].numpy(),
        tree["params"]["patch_embed"]["w"][:, :, 2, 1].astype(np.float32),
    )
    np.testing.assert_array_equal(
        sd["blocks.0.fc1.weight"].numpy(),
        tree["params"]["blocks"][0]["fc1"]["w"].T.astype(np.float32),
    )
    assert set(sd) == {"patch_embed.weight", "patch_embed.bias", "blocks.0.fc1.weight",
                       "blocks.0.fc1.bias", "blocks.0.ln1.weight", "blocks.0.ln1.bias"}
    assert all(t.dtype == torch.float32 for t in sd.values())


def test_seeded_init_is_deterministic_and_has_jax_scales():
    a = torch_vit.vit_tiny(num_classes=10).init_weights(torch.Generator().manual_seed(3)).requires_grad_(False)
    b = torch_vit.vit_tiny(num_classes=10).init_weights(torch.Generator().manual_seed(3)).requires_grad_(False)
    for (name, pa), (_, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(pa, pb, atol=0, rtol=0, msg=name)
    assert float(a.pos_embed.abs().max()) <= 0.04          # trunc normal at 2 std
    assert float(a.blocks[0].ln1.weight.min()) == 1.0
    assert float(a.head.bias.abs().max()) == 0.0
