"""Swin of the port against the JAX package's, weights bridged by
``weights.py`` with ``load_state_dict(strict=True)``.

``swin_micro`` (two stages at 64 px, windows of 16 tokens, one shifted block
with its mask) and a three-stage variant whose last grid fits one window (no
shift there). The JAX model is initialised from a PRNG key; biases and
LayerNorm parameters are then drawn from a numpy seed. On the CPU the port's
window attention is its plain version, with fp32 scores.

- fp32: ``forward`` and ``fold`` + ``apply_folded`` against the JAX ``apply``
  (fp32 scores) and ``apply_folded``: atol 2e-4, rtol 1e-4 on logits divided by
  their largest magnitude.
- bf16: the JAX serving forward keeps its score tensor in bf16, the port's
  stays fp32 on chip. The top-1 class agrees with the fp32 reference on every
  image, and the port's largest logit deviation from the fp32 forward is at
  most twice the JAX bf16 forward's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models import swin as jax_swin
from ics_tpu_torch import weights
from ics_tpu_torch.models import swin as torch_swin
from ics_tpu_torch.ops.window_attention import window_merge, window_partition

CONFIGS = {
    "swin_micro": dict(image_size=64, patch_size=4, embed_dim=32, depths=(1, 2),
                       num_heads=(2, 4), window=4),
    "three_stages": dict(image_size=64, patch_size=4, embed_dim=32, depths=(2, 2, 2),
                         num_heads=(2, 2, 4), window=4),
}


def _randomise(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _randomise(v, rng, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomise(v, rng, path + (i,)) for i, v in enumerate(tree)]
    if path[-1] == "gamma":
        return rng.uniform(0.5, 1.5, tree.shape).astype(np.float32)
    if path[-1] in ("b", "beta"):
        return rng.normal(0, 0.1, tree.shape).astype(np.float32)
    if path[-1] == "rel_bias":
        return rng.normal(0, 0.5, tree.shape).astype(np.float32)
    return np.asarray(tree)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    jmodel = jax_swin.SwinTransformer(num_classes=10, **cfg)
    variables = _randomise(
        jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        np.random.default_rng(5))
    tmodel = torch_swin.SwinTransformer(num_classes=10, **cfg)
    tmodel.load_state_dict(weights.from_jax_variables(variables), strict=True)
    x = np.random.default_rng(1).standard_normal((4, 64, 64, 3)).astype(np.float32)
    return request.param, jmodel, variables, tmodel.eval(), x


def _close(out, ref):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-4, rtol=1e-4)


def test_rel_bias_keeps_its_layout_and_the_bias_free_dense_has_no_bias(pair):
    _, _, variables, tmodel, _ = pair
    sd = weights.from_jax_variables(variables)
    assert set(sd) == set(tmodel.state_dict())
    attn = variables["params"]["stages"][1][1]["attn"]
    # [(2w-1)^2, heads], no permutation
    assert tuple(sd["stages.1.1.attn.rel_bias"].shape) == attn["rel_bias"].shape == \
        (49, tmodel.stages[1][1].attn.num_heads)
    np.testing.assert_array_equal(sd["stages.1.1.attn.rel_bias"].numpy(), attn["rel_bias"])
    merge = variables["params"]["merges"][0]
    assert "b" not in merge["reduction"]
    assert "merges.0.reduction.bias" not in sd and tmodel.merges[0].reduction.bias is None
    np.testing.assert_array_equal(
        sd["merges.0.reduction.weight"].numpy(), merge["reduction"]["w"].T)
    np.testing.assert_array_equal(sd["merges.0.norm.weight"].numpy(), merge["norm"]["gamma"])
    # masks and indices are buffers outside the state dict
    assert not any("cut" in k or "rel_index" in k for k in sd)


def test_masks_and_indices_equal_the_jax_constants(pair):
    _, jmodel, _, tmodel, _ = pair
    for tstage, jstage in zip(tmodel.stages, jmodel.stages):
        for tblk, jblk in zip(tstage, jstage):
            assert (tblk.shift, tblk.grid, tblk.window) == (jblk.shift, jblk.grid, jblk.window)
            np.testing.assert_array_equal(
                tblk.attn.rel_index.numpy(), np.asarray(jblk.attn._rel_index))
            if jblk._mask is None:
                assert tblk.mask() is None
            else:
                assert tblk.mask().dtype == torch.float32
                np.testing.assert_array_equal(tblk.mask().numpy(), np.asarray(jblk._mask))


def test_a_cast_of_the_model_leaves_the_shift_mask_exact():
    model = torch_swin.swin_micro(num_classes=4).init_weights(torch.Generator().manual_seed(0))
    model.to(torch.bfloat16)
    mask = model.stages[1][1].mask()
    assert mask.dtype == torch.float32 and sorted(mask.unique().tolist()) == [-1e4, 0.0]
    assert model.stages[1][0].mask() is None and model.stages[0][0].mask() is None


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


def test_bf16_top1_and_deviation_against_jax(pair):
    _, jmodel, variables, tmodel, x = pair
    ref, _ = jmodel.apply(variables, jnp.asarray(x), training=False)
    ref = np.asarray(ref)
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


def test_patch_merging_takes_timms_quadrant_order():
    rng = np.random.default_rng(2)
    params = {"norm": {"gamma": rng.uniform(0.5, 1.5, 32).astype(np.float32),
                       "beta": rng.normal(0, 0.1, 32).astype(np.float32)},
              "reduction": {"w": rng.normal(0, 0.2, (32, 16)).astype(np.float32)}}
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    ref = np.asarray(jax_swin.PatchMerging(8).apply(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    merge = torch_swin.PatchMerging(8)
    merge.load_state_dict(weights.from_jax_variables(params), strict=True)
    with torch.inference_mode():
        out = merge(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)


def test_window_partition_and_merge_are_inverse_and_match_jax():
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 5)).astype(np.float32)
    ref = np.asarray(jax_swin._window_partition(jnp.asarray(x), 4))
    wins = window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(wins.numpy(), ref)
    np.testing.assert_array_equal(window_merge(wins, 4, 8, 2).numpy(), x)


@pytest.mark.parametrize("name,launches", [
    ("swin_tiny", 12), ("swin_small", 24), ("swin_base", 24), ("swin_micro", 3)])
def test_zoo_constructors_map_the_jax_trees_shape_for_shape(name, launches):
    jmodel = getattr(jax_swin, name)(num_classes=7)
    shapes = weights.mapped_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    tmodel = getattr(torch_swin, name)(num_classes=7, device="meta")
    sd = tmodel.state_dict()
    assert set(sd) == set(shapes)
    assert all(tuple(sd[k].shape) == shapes[k] for k in sd)
    attns = [m for m in tmodel.modules() if isinstance(m, torch_swin.WindowAttention)]
    assert len(attns) == launches                   # one kernel launch per block
    assert all(a.head_dim in (16, 32) and a.window ** 2 <= 64 for a in attns)


def test_init_weights_draws_the_jax_initialisers_distributions():
    model = torch_swin.swin_micro(num_classes=16).init_weights(torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(t).all()) for t in model.state_dict().values())
    table = model.stages[1][0].attn.rel_bias
    assert table.abs().max().item() <= 0.04 + 1e-6 and table.std().item() > 0.01
    assert bool((model.ln.weight == 1).all())


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_forward_goes_through_the_plain_qkv_entry_on_the_cpu(monkeypatch, shift):
    """``SwinBlock.forward`` runs the qkv GEMM on the whole image and hands
    the product to ``window_attention_qkv``, which takes its plain version on
    CPU tensors (no launch); the block equals the JAX block, whose attention
    runs on rolled and partitioned windows (fp32, 2e-4 of the largest output
    as the model tests: the GEMMs see the same rows in another order)."""
    from ics_tpu_torch.ops import LAUNCHES

    jblock = jax_swin.SwinBlock(16, 2, 4, shift, 8)
    variables = _randomise(jax.tree_util.tree_map(
        np.asarray, jblock.init(jax.random.PRNGKey(3))), np.random.default_rng(4))
    tblock = torch_swin.SwinBlock(16, 2, 4, shift, 8)
    tblock.load_state_dict(weights.from_jax_variables(variables), strict=True)
    x = np.random.default_rng(6).standard_normal((2, 8, 8, 16)).astype(np.float32)
    ref = np.asarray(jblock.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                  jnp.asarray(x)))
    calls = []
    entry = torch_swin.window_attention_qkv

    def spy(qkv, *args):
        calls.append((tuple(qkv.shape), args[3:5]))
        return entry(qkv, *args)

    monkeypatch.setattr(torch_swin, "window_attention_qkv", spy)
    before = LAUNCHES["window_attention"].value
    with torch.inference_mode():
        out = tblock(torch.from_numpy(x)).numpy()
    assert calls == [((2, 8, 8, 3, 2, 8), (4, shift))]
    assert LAUNCHES["window_attention"].value == before
    _close(out, ref)
