"""The bottleneck chain of the port against the JAX package's, on the CPU.

``bottleneck_chain_reference`` (what the wrapper computes for CPU tensors,
and what the CUDA kernel is held against on the card) is compared with the
Pallas kernel in interpret mode and with the JAX package's unfused blocks.

Tolerances. fp32: 1e-4 (the same products summed in another order; outputs
are O(1)). bf16 against the Pallas kernel: both round ``a``, ``cmid`` and the
output once, at the same points, from fp32 sums taken in another order, so
they differ only where a sum lands on the other side of a rounding tie: at
most 2 bf16 ulps of the largest output (|y| < 8 here, ulp 2^-5: 0.0625),
and on few elements (mean below 1e-3). bf16 against the unfused blocks, which
round the convolution first and apply scale and bias in bf16: 0.1, the JAX
test's own bar (``tests/test_pallas_bottleneck.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models.resnet import Bottleneck as JaxBottleneck
from ics_tpu.ops import pallas_bottleneck as jax_chain
from ics_tpu_torch import weights
from ics_tpu_torch.models.resnet import Bottleneck
from ics_tpu_torch.ops import bottleneck as torch_chain

BF16_VS_PALLAS = 0.0625
BF16_VS_UNFUSED = 0.1


def _bn(rng, n, bias_mean=0.0):
    return (
        {"gamma": rng.uniform(0.8, 1.2, n).astype(np.float32),
         "beta": rng.normal(bias_mean, 0.1, n).astype(np.float32)},
        {"mean": rng.normal(0, 0.1, n).astype(np.float32),
         "var": rng.uniform(0.8, 1.2, n).astype(np.float32)},
    )


def _chain(n_blocks=2, c=256, cm=64, seed=0, b1_mean=0.0):
    """(jax blocks, jax folded trees in fp32, torch folded blocks) with the
    same weights: conv kernels from the JAX initialiser, BatchNorm drawn
    from the seed so that scale and bias are not trivial."""
    rng = np.random.default_rng(seed)
    jblocks, jfolded, tblocks = [], [], []
    for i in range(n_blocks):
        jb = JaxBottleneck(c, cm, 1)
        params = jax.tree_util.tree_map(
            np.asarray, jb.init(jax.random.fold_in(jax.random.PRNGKey(seed), i)))
        state = {}
        for name, width in (("cbr1", cm), ("cbr2", cm), ("cbr3", c)):
            bn_params, bn_state = _bn(rng, width, b1_mean if name == "cbr1" else 0.0)
            params[name]["bn"] = bn_params
            state[name] = {"bn": bn_state}
        # keep the residual branch small, so the chain's output stays O(1)
        params["cbr3"]["bn"]["gamma"] *= 0.3
        tb = Bottleneck(c, cm, 1)
        tb.load_state_dict(weights.from_jax_variables({"params": params, "state": state}),
                           strict=True)
        for cb in (tb.cbr1, tb.cbr2, tb.cbr3):
            cb.fold()
        jblocks.append(jb)
        jfolded.append(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float32), jb.fold(params, state)))
        tblocks.append(tb)
    return jblocks, jfolded, tblocks


def _x(shape, seed=9):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _jax_bf16(a):
    # through torch's rounding, so both sides see the same bf16 values
    return jnp.asarray(_bf16(a).float().numpy()).astype(jnp.bfloat16)


def test_pack_chain_weights_layouts_equal_the_jax_ones():
    _, jfolded, tblocks = _chain(n_blocks=3, c=128, cm=32)
    ref = jax_chain.pack_chain_weights(jfolded)
    ours = torch_chain.pack_chain_weights(tblocks)
    assert list(ours) == list(ref)
    for key in ref:
        r = np.asarray(ref[key].astype(jnp.float32))
        o = ours[key].float().numpy()
        assert o.shape == r.shape, key
        assert str(ours[key].dtype).endswith(str(ref[key].dtype)), key
        np.testing.assert_allclose(o, r, atol=1e-6, rtol=1e-6, err_msg=key)


def test_pack_rejects_projection_and_unfolded_blocks():
    blk = Bottleneck(64, 64, 1)          # 64 -> 256: has a downsample projection
    for m in blk.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(torch.Generator().manual_seed(0))
    for cb in (blk.cbr1, blk.cbr2, blk.cbr3, blk.down):
        cb.fold()
    with pytest.raises(ValueError, match="identity blocks only"):
        torch_chain.pack_chain_weights([blk])
    with pytest.raises(ValueError, match="folded"):
        torch_chain.pack_chain_weights([Bottleneck(256, 64, 1)])


@pytest.mark.parametrize("shape,tile_rows", [((2, 8, 8, 256), 4), ((2, 7, 7, 256), 7)])
def test_reference_matches_pallas_kernel_and_unfused_blocks_bf16(shape, tile_rows):
    jblocks, jfolded, tblocks = _chain()
    x = _x(shape)
    out = torch_chain.bottleneck_chain_reference(
        _bf16(x), torch_chain.pack_chain_weights(tblocks)).float().numpy()
    assert out.shape == shape and np.abs(out).max() < 8

    pallas = np.asarray(jax_chain.fused_bottleneck_chain(
        _jax_bf16(x), jax_chain.pack_chain_weights(jfolded), tile_rows=tile_rows,
        interpret=True).astype(jnp.float32))
    diff = np.abs(out - pallas)
    assert diff.max() <= BF16_VS_PALLAS, diff.max()
    assert diff.mean() < 1e-3, diff.mean()

    unfused = _jax_bf16(x)
    for blk, f in zip(jblocks, jfolded):
        unfused = blk.apply_folded(
            jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), f), unfused)
    diff = np.abs(out - np.asarray(unfused.astype(jnp.float32)))
    assert diff.max() < BF16_VS_UNFUSED, diff.max()


@pytest.mark.parametrize("shape,tile_rows", [((2, 8, 8, 256), 4), ((2, 7, 7, 256), 7)])
def test_reference_matches_pallas_kernel_and_unfused_blocks_fp32(shape, tile_rows):
    jblocks, jfolded, tblocks = _chain()
    x = _x(shape)
    out = torch_chain.bottleneck_chain_reference(
        torch.from_numpy(x), torch_chain.pack_chain_weights(tblocks, dtype=torch.float32)
    ).numpy()
    pallas = np.asarray(jax_chain.fused_bottleneck_chain(
        jnp.asarray(x), jax_chain.pack_chain_weights(jfolded, dtype=jnp.float32),
        tile_rows=tile_rows, interpret=True))
    np.testing.assert_allclose(out, pallas, atol=1e-4, rtol=0)
    unfused = jnp.asarray(x)
    for blk, f in zip(jblocks, jfolded):
        unfused = blk.apply_folded(f, unfused)
    np.testing.assert_allclose(out, np.asarray(unfused), atol=1e-4, rtol=0)


def test_wrapper_on_cpu_tensors_takes_the_plain_version():
    _, _, tblocks = _chain(n_blocks=1)
    packed = torch_chain.pack_chain_weights(tblocks)
    x = _bf16(_x((1, 5, 6, 256)))
    before = torch_chain.LAUNCHES["bottleneck_chain"].value
    out = torch_chain.bottleneck_chain(x, packed)
    assert torch.equal(out, torch_chain.bottleneck_chain_reference(x, packed))
    assert torch.equal(out, torch_chain.bottleneck_chain(x, torch_chain.ChainWeights(packed)))
    assert torch_chain.LAUNCHES["bottleneck_chain"].value == before   # no kernel ran
    with pytest.raises(ValueError, match=r"\[B, H, W, 256\]"):
        torch_chain.bottleneck_chain(x[..., :128], packed)


def test_zero_border_with_large_positive_bias():
    """Outside the image the 3x3 must see zeros, but relu(0 * w1 * s1 + b1)
    is b1, not 0. With a large positive b1 a chain that padded ``a`` after
    the BatchNorm instead of before it would be far off on the border
    pixels; the plain version agrees with the unfused convolutions (whose
    SAME padding is zeros by construction) on the border as in the interior."""
    jblocks, jfolded, tblocks = _chain(n_blocks=2, b1_mean=3.0)
    x = _x((1, 6, 6, 256), seed=4)
    out = torch_chain.bottleneck_chain_reference(
        torch.from_numpy(x), torch_chain.pack_chain_weights(tblocks, dtype=torch.float32)
    ).numpy()
    unfused = jnp.asarray(x)
    for blk, f in zip(jblocks, jfolded):
        unfused = blk.apply_folded(f, unfused)
    unfused = np.asarray(unfused)
    border = np.ones((6, 6), bool)
    border[1:-1, 1:-1] = False
    np.testing.assert_allclose(out[0][border], unfused[0][border], atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(out[0][~border], unfused[0][~border], atol=1e-3, rtol=1e-4)
    # and the bias really matters there: relu(b1) on the padding ring would
    # move the border by far more than the tolerance
    a_ring = np.maximum(np.asarray(jfolded[0]["cbr1"]["bnf"]["bias"]), 0)
    w2 = np.asarray(jfolded[0]["cbr2"]["conv"]["w"])
    assert np.abs(np.einsum("i,hwio->o", a_ring, w2)).max() > 1.0


def test_chain_weights_keep_their_dtypes_when_the_model_is_cast():
    _, _, tblocks = _chain(n_blocks=2, c=128, cm=32)
    packed = torch_chain.pack_chain_weights(tblocks)
    chain = torch_chain.ChainWeights(packed)
    holder = torch.nn.ModuleDict({"c": chain}).to(torch.bfloat16)
    assert holder["c"].w1.dtype == torch.bfloat16 and holder["c"].s1.dtype == torch.float32
    assert torch.equal(holder["c"].s3, packed["s3"])          # not rounded there and back
    holder = holder.to(torch.float32)
    assert holder["c"].w2.dtype == torch.bfloat16
    w1t, w2t, w3t_blocked = chain.kernel_layout()
    w3t = packed["w3"].transpose(1, 2)
    assert w1t.shape == (2, 32, 128) and w2t.shape == (2, 32, 288) and w3t.shape == (2, 128, 32)
    assert torch.equal(w2t[1], packed["w2"][1].t()) and w2t.is_contiguous()
    # the wgmma kernel's order of the last 1x1's output channels: a permutation
    # within every 32, in which the 8 values a fragment's thread holds of four
    # 8-column blocks are 8 neighbouring channels
    order = torch_chain.expand_row_order(128)
    assert sorted(order.tolist()) == list(range(128))
    assert torch.equal(order // 32, torch.arange(128) // 32)
    for t in range(4):
        held = [int(order[32 + 8 * jj + 2 * t + e]) for jj in range(4) for e in range(2)]
        assert held == list(range(32 + 8 * t, 32 + 8 * t + 8))
    assert torch.equal(w3t_blocked, w3t[:, order]) and w3t_blocked.is_contiguous()


@pytest.mark.parametrize("h,w,cm,expected", [
    (56, 56, 64, 7), (28, 28, 128, 7), (7, 7, 64, 7), (8, 8, 64, 8)])
def test_pick_tile_rows_for_the_resnet50_stages(h, w, cm, expected):
    """The wgmma kernel's tiling at bucket 32: the tile rows that cost the
    fewest passes over whole rounds of the card's multiprocessors, with at
    least three ring stages beside ``a`` and ``cmid``."""
    th = torch_chain.pick_tile_rows(h, w, cm)
    assert th == expected
    stages = torch_chain.ring_stages(th, w, cm)
    assert stages >= 3 and torch_chain._smem_bytes(th, w, cm, stages) <= 232448


# every chained stage of the zoo: (H = W, Cm) of ResNet-50/101/152 stages 0 to
# 3 at 224 px; fold() chains 0 and 1, the kernel is built for all four widths
_CHAIN_SHAPES = [(56, 64), (28, 128), (14, 256)]


@pytest.mark.parametrize("hw,cm", _CHAIN_SHAPES)
@pytest.mark.parametrize("batch", [1, 8, 32, 128])
def test_wgmma_geometry_fits_a_block_at_every_chain_shape(hw, cm, batch):
    th = torch_chain.pick_tile_rows(hw, hw, cm, batch)
    stages = torch_chain.ring_stages(th, hw, cm)
    assert 1 <= th <= hw and 2 <= stages <= 4
    assert torch_chain._smem_bytes(th, hw, cm, stages) <= 232448
    if stages < 4:      # and one more stage would not have fitted
        assert torch_chain._smem_bytes(th, hw, cm, stages + 1) > 232448


@pytest.mark.parametrize("th,w,cm,stages", [(7, 56, 64, 4), (7, 28, 128, 3), (4, 14, 256, 3),
                                            (1, 5, 64, 2)])
def test_smem_formula_of_the_wgmma_kernel(th, w, cm, stages):
    """``_smem_bytes`` against the layout written out: 1024 bytes to align
    the ring, per stage a [128, 64] x tile and a [Cm, 64] weight tile in bf16,
    ``a`` as (th + 2) x (w + 2) pixels and ``cmid`` as th x w pixels of Cm + 8
    bf16 (rounded to 16 bytes), two mbarriers of 8 bytes for each of 4 stages."""
    ring = stages * (128 * 64 * 2 + cm * 64 * 2)
    a = (th + 2) * (w + 2) * (cm + 8) * 2
    cmid = -(-(th * w * (cm + 8) * 2) // 16) * 16
    assert torch_chain._smem_bytes(th, w, cm, stages) == 1024 + ring + a + cmid + 64


def test_ring_stages_shrink_with_the_tile_and_end_at_zero():
    stages = [torch_chain.ring_stages(th, 56, 64) for th in range(1, 20)]
    assert stages == sorted(stages, reverse=True) and stages[0] == 4 and stages[-1] == 0


def test_pick_tile_rows_refuses_a_row_that_cannot_fit():
    with pytest.raises(ValueError, match="does not fit"):
        torch_chain.pick_tile_rows(4, 2000, 256)
