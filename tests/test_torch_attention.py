"""Flash attention of the port against the JAX package's.

On CPU tensors the port's ``flash_attention`` computes its plain version;
the JAX side runs its Pallas kernel in interpret mode, as its own tests
do. Inputs come from numpy with a seed. fp32 tolerance 1e-4: the two
compute the same online/full-row softmax in fp32 and differ only in the
order of the sums. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from ics_tpu.ops import attention as jax_attention
from ics_tpu_torch.ops import attention as torch_attention


def _qkv(shape, seed, k_shift=0.0, v_shift=0.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    return q, k + np.float32(k_shift), v + np.float32(v_shift)


def _both(q, k, v, seq_len=None):
    ours = torch_attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), seq_len
    ).numpy()
    ref = np.asarray(jax_attention.flash_attention(q, k, v, seq_len=seq_len))
    return ours, ref


@pytest.mark.parametrize("shape", [(1, 2, 64, 32), (2, 3, 130, 64)])
def test_matches_jax_flash_fp32(shape):
    ours, ref = _both(*_qkv(shape, seed=0))
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


def test_seq_len_masks_keys_like_jax():
    q, k, v = _qkv((1, 2, 100, 32), seed=1)
    k[:, :, 80:] = 999.0   # garbage past seq_len must not leak in
    v[:, :, 80:] = -999.0
    ours, ref = _both(q, k, v, seq_len=80)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)
    clean, _ = _both(*_qkv((1, 2, 100, 32), seed=1), seq_len=80)
    np.testing.assert_allclose(ours, clean, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seq", [100, 1100])
def test_fully_masked_rows_are_exact_zeros(seq):
    """seq_len=0 masks every key: the flash contract returns exact zeros
    (not the mean of V, which the JAX plain reference returns)."""
    q, k, v = _qkv((1, 1, seq, 32), seed=2, k_shift=100.0, v_shift=-100.0)
    ours, ref = _both(q, k, v, seq_len=0)
    np.testing.assert_array_equal(ref, np.zeros_like(ref))
    np.testing.assert_array_equal(ours, np.zeros_like(ours))


def test_plain_version_in_bf16_matches_jax_flash():
    """bf16 inputs: q pre-scaled in bf16 and P rounded to bf16 before P·V,
    as the TPU kernel does; the outputs agree to one bf16 rounding."""
    import jax.numpy as jnp

    q, k, v = _qkv((1, 2, 130, 64), seed=3)
    ours = torch_attention.flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ).float().numpy()
    ref = np.asarray(jax_attention.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ).astype(jnp.float32))
    np.testing.assert_allclose(ours, ref, atol=1e-2, rtol=1e-2)


def test_wrapper_rejects_mismatched_shapes():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="one \\[B, H, S, D\\] shape"):
        torch_attention.flash_attention(q, q, torch.zeros(1, 2, 8, 16))


def test_seq_len_beyond_sequence_is_clamped():
    """seq_len > S means every key is valid. (The JAX wrapper pads S to 128
    and would count its zero padding keys up to seq_len; the port does not
    pad, so there is nothing to count.)"""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 1, 40, 32), seed=4))
    full = torch_attention.flash_attention(q, k, v)
    longer = torch_attention.flash_attention(q, k, v, seq_len=100)
    torch.testing.assert_close(longer, full, atol=0, rtol=0)
