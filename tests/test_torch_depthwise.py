"""Depthwise convolution of the port against the JAX package's.

On CPU tensors the port's ``depthwise_conv`` computes its plain version,
``depthwise_reference``; the JAX side runs its Pallas kernel in interpret
mode, as ``tests/test_pallas_depthwise.py`` does, and XLA's grouped
convolution. Inputs come from numpy with a seed. fp32 tolerance 1e-5: the
two sum the same k*k fp32 products in another order. The CUDA kernel itself
runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.nn.layers import Conv2D as JaxConv2D
from ics_tpu.ops import pallas_depthwise
from ics_tpu_torch import weights
from ics_tpu_torch.nn.layers import Conv2D
from ics_tpu_torch.ops import LAUNCHES, depthwise

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(shape, k, bias, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, k, shape[-1])) / k).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32) if bias else None
    return x, w, b


@pytest.mark.parametrize("shape,k,bias", [
    ((2, 56, 56, 96), 7, True), ((2, 28, 28, 192), 7, True), ((2, 14, 14, 384), 7, True),
    ((2, 7, 7, 768), 7, True), ((1, 8, 8, 64), 3, False), ((2, 14, 14, 88), 5, False),
    ((1, 1, 1, 16), 3, True),
])
def test_reference_matches_the_pallas_kernel_in_interpret_mode_fp32(shape, k, bias):
    x, w, b = _case(shape, k, bias, seed=shape[-1])
    ref = np.asarray(pallas_depthwise.depthwise_conv(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        interpret=True))
    before = LAUNCHES["depthwise_conv"].value
    out = depthwise.depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(w), None if b is None else torch.from_numpy(b))
    assert LAUNCHES["depthwise_conv"].value == before       # the plain version, no launch
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_reference_matches_xla_grouped_conv_and_takes_every_weight_layout(k):
    c = 24
    x, w, b = _case((2, 9, 11, c), k, True, seed=k)
    conv = JaxConv2D(c, c, k, 1, padding="SAME", groups=c, use_bias=True)
    hwio = w.reshape(k, k, 1, c)
    ref = np.asarray(conv.apply({"w": jnp.asarray(hwio), "b": jnp.asarray(b)}, jnp.asarray(x)))
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    oihw = torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy())
    for taps in (torch.from_numpy(w), torch.from_numpy(hwio), oihw,
                 oihw.contiguous(memory_format=torch.channels_last)):
        out = depthwise.depthwise_reference(xt, taps, bt)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_reference_in_bf16_rounds_once_from_the_fp32_sum():
    x, w, b = _case((2, 14, 14, 32), 7, True, seed=3)
    xb, wb, bb = (torch.from_numpy(a).bfloat16() for a in (x, w, b))
    out = depthwise.depthwise_conv(xb, wb, bb)
    assert out.dtype == torch.bfloat16
    exact = depthwise.depthwise_reference(xb.float(), wb.float(), bb.float())
    torch.testing.assert_close(out, exact.bfloat16(), atol=0, rtol=0)
    ref = np.asarray(pallas_depthwise.depthwise_conv(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16), interpret=True).astype(jnp.float32))
    # one bf16 ulp of the largest output: the two fp32 sums may land on the
    # two sides of a rounding tie
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=ulp, rtol=0)


def test_wrapper_rejects_what_is_not_a_depthwise_call():
    x = torch.zeros(1, 8, 8, 16)
    with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
        depthwise.depthwise_conv(x[0], torch.zeros(3, 3, 16))
    with pytest.raises(ValueError, match="odd k"):
        depthwise.depthwise_conv(x, torch.zeros(4, 4, 16))
    with pytest.raises(ValueError, match="odd k"):
        depthwise.depthwise_conv(x, torch.zeros(3, 3, 8))
    with pytest.raises(ValueError, match="bias of shape"):
        depthwise.depthwise_conv(x, torch.zeros(3, 3, 16), torch.zeros(8))


@pytest.mark.parametrize("kernel,stride,groups,padding,depthwise_path", [
    (7, 1, 16, "SAME", True), (3, 1, 16, 1, True), (5, 1, 16, 2, True),
    (3, 2, 16, 1, False),        # stride 2: outside the kernel's contract, cuDNN
    (3, 1, 4, 1, False),         # grouped, not depthwise
    (3, 1, 16, 0, False),        # no padding: another function
    (1, 1, 16, 0, False),
])
def test_conv2d_marks_exactly_the_kernels_contract_as_depthwise(kernel, stride, groups,
                                                                 padding, depthwise_path):
    conv = Conv2D(16, 16, kernel, stride, padding=padding, groups=groups)
    assert conv.depthwise is depthwise_path and conv.use_kernel is True


@pytest.mark.parametrize("k,bias", [(7, True), (3, False), (5, False)])
def test_depthwise_conv2d_module_matches_jax_with_bridged_weights(k, bias):
    c = 40
    rng = np.random.default_rng(k)
    params = {"w": rng.normal(0, 0.2, (k, k, 1, c)).astype(np.float32)}
    if bias:
        params["b"] = rng.standard_normal(c).astype(np.float32)
    x = rng.standard_normal((2, 12, 10, c)).astype(np.float32)
    jconv = JaxConv2D(c, c, k, 1, padding=k // 2, groups=c, use_bias=bias)
    ref = np.asarray(jconv.apply({k_: jnp.asarray(v) for k_, v in params.items()},
                                 jnp.asarray(x)))
    conv = Conv2D(c, c, k, 1, padding=k // 2, groups=c, use_bias=bias)
    state = weights.from_jax_variables(params)
    assert tuple(state["weight"].shape) == (c, 1, k, k)      # HWIO [k,k,1,C] -> OIHW
    conv.load_state_dict(state, strict=True)
    with torch.inference_mode():
        out = conv(torch.from_numpy(x))
        same = depthwise.depthwise_conv(
            torch.from_numpy(x), conv.weight, conv.bias if bias else None)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(same.numpy(), ref, **TOL)


# ---- what the kernel's host side decides in Python -----------------------------------

_B4 = [((32, 190, 190, 24), 3), ((32, 190, 190, 48), 3), ((32, 95, 95, 192), 3),
       ((32, 48, 48, 336), 5), ((32, 24, 24, 672), 3), ((32, 24, 24, 672), 5),
       ((32, 24, 24, 960), 5), ((32, 12, 12, 1632), 3), ((32, 12, 12, 1632), 5),
       ((32, 12, 12, 2688), 3)]
_MNV3 = [((32, 28, 28, 88), 3), ((32, 14, 14, 120), 5), ((32, 14, 14, 144), 5),
         ((32, 14, 14, 240), 5), ((32, 7, 7, 576), 5)]
_CONVNEXT = [((32, 56, 56, 96), 7), ((32, 28, 28, 192), 7), ((32, 14, 14, 384), 7),
             ((32, 7, 7, 768), 7)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape,k", _B4 + _MNV3 + _CONVNEXT + [((1, 1, 1, 8), 3),
                                                              ((2, 3, 2, 40), 7)])
def test_strip_geometry_holds_the_kernels_limits_at_every_zoo_shape(shape, k, itemsize):
    """``strip_geometry`` against what ``launch_strip`` in the source refuses,
    for the wide and the narrow thread shape: runs of whole 16-byte pieces, at
    most 4 pieces a thread and row, the ring within 48 KB, at most 256
    threads, full coverage of W, H and C."""
    b, h, w, c = shape
    shapes = depthwise.STRIP_SHAPES[(itemsize, k)]
    assert len(shapes) == 2 and shapes[1][1] == 1            # wide, then one column a thread
    for ch, cols in shapes:
        geometry = depthwise.strip_geometry(b, h, w, c, k, itemsize, ch, cols)
        assert geometry is not None
        assert geometry[:2] == (ch, cols)
        _, _, cb, tw, rh = geometry
        run = cb * ch * itemsize
        pieces = (tw * cols + k - 1) * run // 16
        threads = cb * tw
        assert c % ch == 0 and run % 16 == 0 and 1 <= threads <= 256
        assert pieces <= depthwise.STRIP_MAX_PIECES * threads
        assert depthwise.STRIP_STAGES * pieces * 16 <= depthwise.STRIP_MAX_SMEM
        assert 1 <= tw <= -(-w // cols) and 1 <= rh <= h
        assert cb == c // ch or run >= depthwise.STRIP_MIN_RUN_BYTES[k]
        assert depthwise.strip_blocks(geometry, b, h, w, c) == (
            -(-c // (cb * ch)) * -(-w // (tw * cols)) * -(-h // rh) * b)
        # no lane of a C = 24 or 48 tensor idles: a pixel's channels are one run
        if c * itemsize <= 128:
            assert cb * ch == c


@pytest.mark.parametrize("bucket", [1, 8, 32])
@pytest.mark.parametrize("shape,k", _B4 + _MNV3 + _CONVNEXT)
def test_plan_fills_the_card_or_falls_back(shape, k, bucket):
    """``pick_plan`` at the three serving buckets: the wide thread shape
    wherever its grid has ``STRIP_MIN_BLOCKS_WIDE`` blocks; else the narrow one
    with a grid of ``STRIP_MIN_BLOCKS_NARROW`` to ``STRIP_MAX_BLOCKS_NARROW`` blocks,
    or a smaller one of short strips at k 5 and 7; else the tile kernel;
    ``pick_variant`` and ``pick_geometry`` say the same."""
    call = (bucket, *shape[1:])
    variant, geometry = depthwise.pick_plan(*call, k, 2)
    wide, narrow = (depthwise.strip_geometry(*call, k, 2, ch, cols)
                    for ch, cols in depthwise.STRIP_SHAPES[(2, k)])
    blocks = [depthwise.strip_blocks(g, *call) for g in (wide, narrow)]
    short = k >= 5 and narrow[4] <= depthwise.STRIP_SHORT_ROWS
    if blocks[0] >= depthwise.STRIP_MIN_BLOCKS_WIDE[k]:
        assert (variant, geometry) == ("strip", wide)
    elif blocks[1] <= depthwise.STRIP_MAX_BLOCKS_NARROW and (
            blocks[1] >= depthwise.STRIP_MIN_BLOCKS_NARROW[k] or short):
        assert (variant, geometry) == ("strip", narrow)
    else:
        assert (variant, geometry) == ("tile", None)
    assert depthwise.pick_variant(call, k, torch.bfloat16) == variant
    assert depthwise.pick_geometry(*call, k, 2) == (geometry or wide)
    if bucket == 32 and shape[1] * shape[2] * shape[3] >= 24 * 24 * 672:
        assert geometry == wide                               # the large calls of a full batch


@pytest.mark.parametrize("shape,k,expected", [
    ((32, 14, 14, 240), 5, "narrow"),     # 160 wide blocks: too few at k 5
    ((32, 7, 7, 576), 5, "narrow"),       # 192
    ((8, 12, 12, 1632), 5, "wide"),       # 208
    ((8, 24, 24, 672), 5, "tile"),        # 168 wide blocks, 336 narrow: over one round
    ((8, 7, 7, 576), 5, "narrow"),        # a small grid of short strips
    ((1, 12, 12, 1632), 5, "narrow"),
    ((1, 7, 7, 768), 7, "narrow"),
    ((1, 12, 12, 1632), 3, "tile"),       # k 3: the tile kernel's pass is the shorter
    ((8, 14, 14, 240), 5, "tile"),        # 14 rows: no short strip
    ((32, 7, 7, 768), 7, "wide"),
    ((8, 28, 28, 192), 7, "narrow"),
    ((1, 95, 95, 192), 3, "tile"),        # 126 narrow blocks: under one a multiprocessor
    ((8, 12, 12, 1632), 3, "narrow"),     # 208
])
def test_plan_at_the_small_calls_is_the_one_measured_fastest(shape, k, expected):
    """The kernel that was fastest in turns on an H100 at the small bf16 calls
    of MobileNetV3-Small, EfficientNet-B4 and ConvNeXt-T."""
    variant, geometry = depthwise.pick_plan(*shape, k, 2)
    if expected == "tile":
        assert variant == "tile"
    else:
        assert variant == "strip"
        assert geometry[:2] == depthwise.STRIP_SHAPES[(2, k)][expected == "narrow"]


@pytest.mark.parametrize("shape,k,dtype,aligned,expected", [
    ((32, 190, 190, 24), 3, torch.bfloat16, True, "strip"),
    ((32, 24, 24, 960), 5, torch.bfloat16, True, "strip"),
    ((32, 28, 28, 192), 7, torch.bfloat16, True, "strip"),
    ((32, 56, 56, 96), 7, torch.bfloat16, True, "strip"),
    ((32, 56, 56, 96), 7, torch.float32, True, "strip"),
    ((1, 56, 56, 96), 7, torch.bfloat16, True, "tile"),       # one image: too few strip blocks
    ((2, 10, 6, 15), 3, torch.bfloat16, True, "direct"),      # an odd C
    ((2, 10, 6, 20), 3, torch.bfloat16, True, "tile"),        # 40 bytes a pixel: no 16-byte pieces
    ((64, 40, 40, 20), 3, torch.bfloat16, True, "tile"),      # the same, however large
    ((64, 40, 40, 20), 3, torch.float32, True, "strip"),      # 80 bytes a pixel
    ((1, 11, 11, 32), 9, torch.bfloat16, True, "direct"),     # k 9
    ((32, 24, 24, 672), 3, torch.bfloat16, False, "direct"),  # a pointer off 16 bytes
])
def test_variant_choice(shape, k, dtype, aligned, expected):
    assert depthwise.pick_variant(shape, k, dtype, aligned) == expected


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("layout", ["kkc", "hwio", "oihw", "oihw_channels_last"])
def test_kernel_taps_are_dense_tap_major_whatever_the_layout(k, layout):
    c = 24
    w = torch.from_numpy(np.random.default_rng(k).standard_normal((k, k, c)).astype(np.float32))
    given = {"kkc": w, "hwio": w.reshape(k, k, 1, c),
             "oihw": w.permute(2, 0, 1).reshape(c, 1, k, k).contiguous(),
             "oihw_channels_last": w.permute(2, 0, 1).reshape(c, 1, k, k).contiguous(
                 memory_format=torch.channels_last)}[layout]
    taps = depthwise.kernel_taps(given, c)
    assert taps.shape == (k * k, c) and taps.is_contiguous()
    assert torch.equal(taps, w.reshape(k * k, c))
    assert depthwise.kernel_taps(given, c, torch.bfloat16).dtype == torch.bfloat16
    if layout in ("kkc", "hwio"):
        assert taps.data_ptr() == w.data_ptr()               # a view, no copy


def test_module_keeps_its_taps_until_the_weight_moves_is_cast_or_is_written():
    """``Conv2D.kernel_operands``: made once, equal to the module's weight
    in the kernel's layout, made anew after ``.to(dtype)``, after
    ``load_state_dict`` and after ``fold``'s change of memory format; the
    state dict never carries them."""
    c, k = 16, 5
    conv = Conv2D(c, c, k, 1, padding=2, groups=c, use_bias=True)
    conv.reset_parameters(torch.Generator().manual_seed(0))

    def expected(dtype):
        return conv.weight.detach().to(dtype).permute(2, 3, 1, 0).reshape(k * k, c)

    taps, bias = conv.kernel_operands(torch.float32)
    assert torch.equal(taps, expected(torch.float32)) and torch.equal(bias, conv.bias)
    again, _ = conv.kernel_operands(torch.float32)
    assert again is taps                                       # kept, not made again
    half, half_bias = conv.kernel_operands(torch.bfloat16)     # another activation dtype
    assert half.dtype == half_bias.dtype == torch.bfloat16
    assert torch.equal(half, expected(torch.bfloat16))
    conv.to(torch.bfloat16)
    cast, _ = conv.kernel_operands(torch.bfloat16)
    assert cast is not half and torch.equal(cast, expected(torch.bfloat16))
    fresh = Conv2D(c, c, k, 1, padding=2, groups=c, use_bias=True)
    fresh.reset_parameters(torch.Generator().manual_seed(1))
    conv.to(torch.float32).load_state_dict(fresh.state_dict())
    first, first_bias = conv.kernel_operands(torch.float32)
    first_bias = first_bias.clone()        # in the weight's dtype the bias is the parameter itself
    assert torch.equal(first, fresh.weight.detach().permute(2, 3, 1, 0).reshape(k * k, c))
    fresh.reset_parameters(torch.Generator().manual_seed(2))
    with torch.no_grad():
        fresh.bias.add_(1.5)
    conv.load_state_dict(fresh.state_dict())                   # written in place
    second, second_bias = conv.kernel_operands(torch.float32)
    assert second is not first and torch.equal(second, expected(torch.float32))
    assert torch.equal(second_bias, fresh.bias) and not torch.equal(second_bias, first_bias)
    conv.weight.data = conv.weight.data.contiguous(memory_format=torch.channels_last)
    assert torch.equal(conv.kernel_operands(torch.float32)[0], second)
    assert sorted(conv.state_dict()) == ["bias", "weight"]
    assert tuple(conv.state_dict()["weight"].shape) == (c, 1, k, k)


# ---- the gradients of the taps and the bias (training) ---------------------------
#
# The JAX package trains the depthwise convolution through XLA (its Pallas
# kernel has no backward): jax.grad of its Conv2D against the port's plain
# version of ``depthwise_conv_dw`` and autograd of the port's Conv2D, fp32,
# 1e-5 of the largest gradient (the same products summed in another order).

@pytest.mark.parametrize("shape,k", [((2, 14, 14, 24), 7), ((3, 9, 7, 16), 3),
                                     ((2, 6, 11, 40), 5), ((1, 1, 1, 8), 3)])
def test_taps_and_bias_gradients_match_jax(shape, k):
    import jax

    x, w, b = _case(shape, k, True, seed=k)
    dy = np.random.default_rng(k + 1).standard_normal(shape).astype(np.float32)
    c = shape[-1]
    jconv = JaxConv2D(c, c, k, 1, padding="SAME", groups=c, use_bias=True)
    params = {"w": jnp.asarray(w[:, :, None, :]), "b": jnp.asarray(b)}
    grads = jax.grad(lambda p: jnp.sum(jconv.apply(p, jnp.asarray(x)) * dy))(params)
    ref_w = np.asarray(grads["w"])[:, :, 0, :].reshape(k * k, c)
    ref_b = np.asarray(grads["b"])
    dtaps, dbias = depthwise.depthwise_conv_dw(torch.from_numpy(x), torch.from_numpy(dy), k)
    for ours, ref in ((dtaps, ref_w), (dbias, ref_b)):
        assert ours.dtype == torch.float32
        assert np.abs(ours.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    conv = Conv2D(c, c, k, 1, padding=k // 2, groups=c, use_bias=True)
    conv.load_state_dict(weights.from_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, params)}))
    (conv(torch.from_numpy(x)) * torch.from_numpy(dy)).sum().backward()
    assert np.abs(conv.weight.grad.numpy().reshape(c, k * k).T - ref_w).max() \
        <= 1e-5 * np.abs(ref_w).max()
    assert np.abs(conv.bias.grad.numpy() - ref_b).max() <= 1e-5 * np.abs(ref_b).max()
    assert depthwise.depthwise_conv_dw(torch.from_numpy(x), torch.from_numpy(dy), k,
                                       with_bias=False)[1] is None


@pytest.mark.parametrize("layout", ["kk_c", "kkc", "hwio", "oihw"])
def test_taps_gradient_comes_back_in_the_weights_layout(layout):
    k, c = 5, 6
    dtaps = torch.arange(k * k * c, dtype=torch.float32).reshape(k * k, c)
    like = {"kk_c": torch.empty(k * k, c), "kkc": torch.empty(k, k, c),
            "hwio": torch.empty(k, k, 1, c), "oihw": torch.empty(c, 1, k, k)}[layout]
    grad = depthwise._taps_grad(dtaps, like.to(torch.bfloat16))
    assert grad.shape == like.shape and grad.dtype == torch.bfloat16
    assert torch.equal(depthwise.kernel_taps(grad.float(), c) if grad.dim() != 2 else
                       grad.float(), dtaps)


@pytest.mark.parametrize("b,h,w,c,resident", [
    (32, 56, 56, 96, 660), (32, 7, 7, 768, 660), (1, 95, 95, 192, 1188),
    (32, 190, 190, 48, 1056), (1, 1, 1, 16, 1188), (8, 12, 12, 1632, 660), (1, 5, 2, 8, 1),
])
def test_taps_gradient_plan_fills_the_card_once_and_covers_every_row_and_column(b, h, w, c,
                                                                               resident):
    tile_w, rows, runs = depthwise.dw_grad_plan(b, h, w, c, resident)
    tiles = -(-w // tile_w)
    assert 1 <= tile_w <= depthwise.DW_TILE_COLS and (tiles - 1) * tile_w < w
    assert tile_w == -(-w // tiles)                          # tiles of equal width but the last
    assert rows >= 1 and (runs - 1) * rows < b * h <= runs * rows
    slices = -(-c // depthwise.DW_CHANNELS)
    budget = max(1, min(resident // (slices * tiles), depthwise.DW_MAX_RUNS // tiles))
    assert runs <= budget                                    # one wave, few partial rows
    assert rows == 1 or -(-b * h // (rows - 1)) > budget     # and no run longer than it must be


def test_an_optimizer_step_makes_the_cached_taps_anew():
    """A training step writes the weight in place: the taps the kernel reads
    follow it (the version counter moves), so no stale taps are launched."""
    c, k = 8, 3
    conv = Conv2D(c, c, k, 1, padding=1, groups=c, use_bias=True)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.SGD(conv.parameters(), lr=0.5, momentum=0.9)
    for _ in range(2):
        taps, bias = conv.kernel_operands(torch.float32)
        before = taps.clone()
        conv(torch.randn(2, 5, 5, c)).square().sum().backward()
        opt.step()
        opt.zero_grad()
        after, after_bias = conv.kernel_operands(torch.float32)
        assert not torch.equal(after, before)
        assert torch.equal(after, depthwise.kernel_taps(conv.weight.detach(), c))
        assert torch.equal(after_bias, conv.bias.detach())
