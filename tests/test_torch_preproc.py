"""Preprocessing of the port against the JAX package's, in fp32.

Mixed image sizes staged top-left in one 512 canvas; the PIL-grid resize,
center crop and ImageNet normalize must agree to 1e-4 (fp32 matmuls over
the same triangle weights, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.ops import preproc as jax_preproc
from ics_tpu.runtime.decode import stage_batch
from ics_tpu_torch.ops import preproc as torch_preproc


def _staged(seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(512, 512), (300, 200), (97, 480), (256, 256), (40, 33)]
    images = [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in shapes]
    return stage_batch(images, canvas=512)


@pytest.mark.parametrize("out_size,resize_short", [(224, 256), (384, 384), (64, 64)])
def test_preprocess_batch_matches_jax_fp32(out_size, resize_short):
    canvas, sizes = _staged()
    ours = torch_preproc.preprocess_batch(
        torch.from_numpy(canvas), torch.from_numpy(sizes), out_size=out_size,
        resize_short=resize_short, dtype=torch.float32,
    ).numpy()
    ref = np.asarray(jax_preproc.preprocess_batch(
        canvas, sizes, out_size=out_size, resize_short=resize_short,
        dtype=jnp.float32,
    ))
    assert ours.shape == (len(sizes), out_size, out_size, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


def test_triangle_weights_match_jax():
    h = np.float32(300.0)
    (sy, oy), _ = jax_preproc._resize_plan(h, np.float32(200.0), 224, 256)
    ref = np.asarray(jax_preproc._triangle_weights(512, 224, h, sy, oy))
    (tsy, toy), _ = torch_preproc._resize_plan(
        torch.tensor([300.0]), torch.tensor([200.0]), 224, 256
    )
    ours = torch_preproc._triangle_weights(512, 224, torch.tensor([300.0]), tsy, toy)[0]
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(ours.sum(dim=1).numpy(), 1.0, atol=1e-5)


def test_bf16_output_is_the_rounded_fp32_output():
    canvas, sizes = _staged(seed=1)
    args = (torch.from_numpy(canvas), torch.from_numpy(sizes))
    f32 = torch_preproc.preprocess_batch(*args, dtype=torch.float32)
    bf16 = torch_preproc.preprocess_batch(*args, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, f32.to(torch.bfloat16), atol=0, rtol=0)
