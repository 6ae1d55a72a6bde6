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
