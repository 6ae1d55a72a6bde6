"""uint8 normalize of the port against the JAX package's: ``normalize_only``
and the ``normalize_u8`` wrapper (which takes the plain version on CPU
tensors) against ``pallas_normalize`` (interpret mode) and ``normalize_only``
of JAX, atol 1e-5 in fp32 (``tests/test_ops_preproc.py``): the kernel
computes ``x * scale + bias``, the plain versions ``(x - mean) / std``.
In bf16 the two may round a value to neighbouring bf16 numbers: one ulp of
the largest output (|y| < 4: 2^-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.ops.pallas_preproc import pallas_normalize
from ics_tpu.ops.preproc import normalize_only as jax_normalize_only
from ics_tpu_torch.ops import LAUNCHES
from ics_tpu_torch.ops.normalize import affine, normalize_u8
from ics_tpu_torch.ops.preproc import normalize_only, preprocess_batch

SHAPES = [(2, 224, 224, 3), (1, 7, 13, 3)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fn", [normalize_only, normalize_u8])
def test_fp32_matches_pallas_kernel_and_jax_plain_version(fn, shape):
    x = np.random.default_rng(7).integers(0, 256, shape, np.uint8)
    out = fn(torch.from_numpy(x), dtype=torch.float32).numpy()
    assert out.shape == shape and out.dtype == np.float32
    np.testing.assert_allclose(
        out, np.asarray(pallas_normalize(x, dtype=jnp.float32)), atol=1e-5)
    np.testing.assert_allclose(
        out, np.asarray(jax_normalize_only(x, dtype=jnp.float32)), atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_is_within_one_ulp_of_the_pallas_kernel(shape):
    x = np.random.default_rng(8).integers(0, 256, shape, np.uint8)
    out = normalize_u8(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(pallas_normalize(x).astype(jnp.float32))
    assert np.abs(out.float().numpy() - ref).max() <= 2.0 ** -6


def test_strided_window_of_a_larger_canvas():
    canvas = np.random.default_rng(9).integers(0, 256, (3, 96, 128, 3), np.uint8)
    window = torch.from_numpy(canvas)[:, :64, :64]
    assert not window.is_contiguous()
    before = LAUNCHES["normalize_u8"].value
    out = normalize_u8(window, dtype=torch.float32)
    assert LAUNCHES["normalize_u8"].value == before      # CPU tensor: no kernel ran
    assert out.is_contiguous() and out.shape == (3, 64, 64, 3)
    ref = np.asarray(jax_normalize_only(np.ascontiguousarray(canvas[:, :64, :64]),
                                        dtype=jnp.float32))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_exact_size_images_make_the_resize_an_identity():
    """What the engine's fixed-size lane rests on: for an image that is
    exactly out x out and resize_short == out, preprocess_batch equals
    normalize_only of the canvas window, to fp32 rounding."""
    canvas = np.zeros((2, 128, 128, 3), np.uint8)
    canvas[:, :64, :64] = np.random.default_rng(10).integers(0, 256, (2, 64, 64, 3), np.uint8)
    sizes = np.full((2, 2), 64, np.int32)
    resized = preprocess_batch(torch.from_numpy(canvas), torch.from_numpy(sizes),
                               out_size=64, resize_short=64, dtype=torch.float32)
    fixed = normalize_u8(torch.from_numpy(canvas)[:, :64, :64], dtype=torch.float32)
    np.testing.assert_allclose(fixed.numpy(), resized.numpy(), atol=1e-5)


def test_affine_constants_are_the_tpu_wrappers():
    scale, bias = affine()
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    np.testing.assert_array_equal(np.asarray(scale, np.float32), np.float32(1.0) / (np.float32(255.0) * std))
    np.testing.assert_array_equal(np.asarray(bias, np.float32), -mean / std)


def test_wrapper_rejects_what_is_not_a_uint8_image_batch():
    with pytest.raises(ValueError, match="uint8"):
        normalize_u8(torch.zeros((1, 4, 4, 3)))
    with pytest.raises(ValueError, match="uint8"):
        normalize_u8(torch.zeros((4, 4, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        normalize_u8(torch.zeros((1, 4, 4, 4), dtype=torch.uint8))
