"""Window attention of the port against the JAX prototype it replaces.

``scripts/proto_window_attn.py`` is loaded from its path. On CPU tensors the
port's ``window_attention`` computes its plain version,
``window_attention_reference``; the JAX side runs the Pallas kernel in
interpret mode and the script's XLA reference with fp32 scores. Inputs come
from numpy with a seed. fp32 tolerance 1e-4, the script's own bar: the same
fp32 softmax with sums in another order. The CUDA kernel itself runs only on
the card (``tests/test_torch_cuda.py``).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models.swin import _shift_attn_mask
from ics_tpu_torch.ops import LAUNCHES, window_attention as wa

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def proto():
    spec = importlib.util.spec_from_file_location(
        "proto_window_attn", REPO / "scripts" / "proto_window_attn.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(grid, window, heads, hd, batch, seed, masked=True):
    ww = window * window
    n_w = (grid // window) ** 2
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((batch * n_w, heads, ww, hd)).astype(np.float32)
               for _ in range(3))
    q *= hd ** -0.5
    bias = rng.standard_normal((heads, ww, ww)).astype(np.float32)
    mask = _shift_attn_mask(grid, window, window // 2) if masked and n_w > 1 else None
    return q, k, v, bias, mask


def _port(q, k, v, bias, mask, dtype=torch.float32):
    return wa.window_attention(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("grid,window,heads,hd,batch", [
    (14, 7, 4, 32, 2),      # the script's own check: 4 windows of 49 tokens
    (28, 7, 2, 32, 1),      # 16 windows
    (8, 4, 2, 16, 2),       # swin_micro: windows of 16 tokens, head_dim 16
])
def test_reference_matches_the_pallas_prototype_and_its_xla_reference_fp32(
        proto, grid, window, heads, hd, batch):
    q, k, v, bias, mask = _inputs(grid, window, heads, hd, batch, seed=grid)
    args = tuple(jnp.asarray(a) for a in (q, k, v, bias, mask))
    xla = np.asarray(proto.xla_window_attention(*args, score_dtype_is_input=False))
    pallas = np.asarray(proto.pallas_window_attention(*args, tile=4, interpret=True))
    before = LAUNCHES["window_attention"].value
    out = _port(q, k, v, bias, mask)
    assert LAUNCHES["window_attention"].value == before    # the plain version, no launch
    assert out.shape == xla.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), pallas, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.numpy(), xla, atol=1e-4, rtol=0)


def test_no_mask_equals_a_mask_of_zeros(proto):
    """Unshifted blocks and single-window grids pass no mask."""
    q, k, v, bias, _ = _inputs(7, 7, 3, 32, 3, seed=1, masked=False)
    zeros = np.zeros((1, 49, 49), np.float32)
    ref = np.asarray(proto.xla_window_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias, zeros)), score_dtype_is_input=False))
    np.testing.assert_allclose(_port(q, k, v, bias, None).numpy(), ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(_port(q, k, v, bias, zeros), _port(q, k, v, bias, None),
                               atol=0, rtol=0)


def test_mask_window_follows_row_mod_n_windows_and_cuts_attention():
    """Rows are image-major: row b uses mask[b mod nW]. A masked pair gets
    probability 0, so moving the values of the cut keys changes nothing."""
    q, k, v, bias, mask = _inputs(14, 7, 2, 16, 2, seed=2)
    out = _port(q, k, v, bias, mask)
    assert np.any(mask[3] != 0) and not np.any(mask[0] != 0)
    row = 4 + 3                                   # second image, window 3
    cut = mask[3][0] != 0                         # keys cut off from query 0
    v2 = v.copy()
    v2[row, :, cut] += 100.0
    out2 = _port(q, k, v2, bias, mask)
    torch.testing.assert_close(out2[row, :, 0], out[row, :, 0], atol=1e-5, rtol=0)
    assert (out2[row, :, 1:] - out[row, :, 1:]).abs().max() > 1.0


def test_reference_in_bf16_rounds_p_and_the_output_once(proto):
    q, k, v, bias, mask = _inputs(14, 7, 4, 32, 1, seed=3)
    out = _port(q, k, v, bias, mask, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(proto.pallas_window_attention(
        qb, kb, vb, jnp.asarray(bias), jnp.asarray(mask), tile=4, interpret=True
    ).astype(jnp.float32))
    # outputs are O(1); one bf16 ulp at 1.0 is 7.8e-3
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=0)


def test_wrapper_rejects_mismatched_shapes():
    q = torch.zeros(4, 2, 16, 16)
    bias = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="one \\[Bn, H, ww, hd\\] shape"):
        wa.window_attention(q, q, torch.zeros(4, 2, 16, 32), bias)
    with pytest.raises(ValueError, match="bias as \\[H, ww, ww\\]"):
        wa.window_attention(q, q, q, torch.zeros(3, 16, 16))
    with pytest.raises(ValueError, match="nW dividing Bn"):
        wa.window_attention(q, q, q, bias, torch.zeros(3, 16, 16))
    with pytest.raises(ValueError, match="nW dividing Bn"):
        wa.window_attention(q, q, q, bias, torch.zeros(4, 16, 8))
