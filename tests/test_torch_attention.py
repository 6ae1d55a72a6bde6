"""Flash attention of the port against the JAX package's.

On CPU tensors the port's ``flash_attention`` computes its plain version;
the JAX side runs its Pallas kernel in interpret mode, as its own tests
do. Inputs come from numpy with a seed. fp32 tolerance 1e-4: the two
compute the same online/full-row softmax in fp32 and differ only in the
order of the sums. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).

``bf16_exp=True`` takes ``exp`` on a bf16 argument, so each p carries a
relative error of up to 2^-8 times ``|s - m|·log2(e)`` (below 2^-5 for the
weights that matter) on top of its own bf16 rounding; the outputs are O(1)
and the bar is 2e-2, twice the bf16 bar of the exact variant.
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


@pytest.mark.parametrize("shape,seq_len", [((1, 2, 130, 64), None), ((2, 3, 577, 32), 300)])
def test_bf16_exp_plain_version_stays_within_the_bf16_bar_of_jax(shape, seq_len):
    import jax.numpy as jnp

    q, k, v = _qkv(shape, seed=5)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ours = torch_attention.flash_attention(qb, kb, vb, seq_len, bf16_exp=True)
    assert ours.dtype == torch.bfloat16
    ref = np.asarray(jax_attention.attention_reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        seq_len=shape[2] if seq_len is None else seq_len).astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=2e-2, rtol=0)
    exact = torch_attention.flash_attention(qb, kb, vb, seq_len)
    np.testing.assert_allclose(ours.float().numpy(), exact.float().numpy(), atol=2e-2, rtol=0)
    assert not torch.equal(ours, exact)              # it is another rounding, not a no-op


def test_bf16_exp_matches_the_script_variants_single_pass_formula():
    """``scripts/bench_vit_attn.py:75-77``: p = exp((s - m) in bf16), the row
    sum in fp32, over the whole row at once. The port tiles the keys by 64
    and takes 2^x on (s - m)·log2(e): the same function to the bf16 bar."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv((1, 2, 200, 64), seed=6))
    scale = torch.tensor(64 ** -0.5, dtype=torch.bfloat16)
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    p = torch.exp((s - s.amax(-1, keepdim=True)).to(torch.bfloat16))
    script = torch.matmul(p.float(), v.float()) / p.float().sum(-1, keepdim=True)
    ours = torch_attention.attention_reference(q, k, v, bf16_exp=True)
    np.testing.assert_allclose(ours.float().numpy(), script.numpy(), atol=2e-2, rtol=0)


def test_bf16_exp_keeps_the_flash_contract_and_needs_bf16():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv((1, 1, 100, 32), seed=7, k_shift=100.0, v_shift=-100.0))
    zeros = torch_attention.flash_attention(q, k, v, seq_len=0, bf16_exp=True)
    assert bool((zeros == 0).all())
    with pytest.raises(ValueError, match="bf16_exp needs bf16"):
        torch_attention.flash_attention(q.float(), k.float(), v.float(), bf16_exp=True)


# ---- strided inputs and the fused qkv entry point ---------------------------------

def _fused_qkv(b, s, h, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, 3, h, d)).astype(np.float32)


@pytest.mark.parametrize("shape,seq_len", [((1, 64, 2, 32), None), ((2, 130, 3, 64), None),
                                           ((2, 130, 3, 64), 100)])
def test_qkv_entry_point_matches_jax_flash_on_the_transposed_slices(shape, seq_len):
    """``flash_attention_qkv`` takes ViT's fused product as it lies,
    [B, S, 3, H, D], and returns [B, S, H, D]; the JAX kernel gets the three
    [B, H, S, D] slices. fp32 tolerance 1e-4 as above."""
    qkv = _fused_qkv(*shape, seed=8)
    ours = torch_attention.flash_attention_qkv(torch.from_numpy(qkv), seq_len)
    q, k, v = (np.ascontiguousarray(qkv[:, :, i].transpose(0, 2, 1, 3)) for i in range(3))
    ref = np.asarray(jax_attention.flash_attention(q, k, v, seq_len=seq_len))
    assert ours.shape == (shape[0], shape[1], shape[2], shape[3]) and ours.is_contiguous()
    np.testing.assert_allclose(ours.numpy(), ref.transpose(0, 2, 1, 3), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype,bf16_exp", [(torch.float32, False), (torch.bfloat16, False),
                                            (torch.bfloat16, True)])
def test_qkv_entry_point_and_strided_views_equal_contiguous_copies(dtype, bf16_exp):
    qkv = torch.from_numpy(_fused_qkv(2, 100, 3, 32, seed=9)).to(dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)               # [B, H, S, D] views
    assert not q.is_contiguous()
    copies = torch_attention.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), 80, bf16_exp)
    views = torch_attention.flash_attention(q, k, v, 80, bf16_exp)
    fused = torch_attention.flash_attention_qkv(qkv, 80, bf16_exp)
    assert torch.equal(views, copies)
    assert torch.equal(fused, copies.transpose(1, 2))
    assert fused.reshape(2, 100, 96).data_ptr() == fused.data_ptr()   # a view, no copy


def test_qkv_entry_point_fully_masked_is_exact_zeros_and_rejects_other_layouts():
    qkv = torch.from_numpy(_fused_qkv(1, 70, 2, 32, seed=10)) + 100.0
    out = torch_attention.flash_attention_qkv(qkv, seq_len=0)
    assert out.shape == (1, 70, 2, 32) and bool((out == 0).all())
    with pytest.raises(ValueError, match=r"\[B, S, 3, H, D\]"):
        torch_attention.flash_attention_qkv(qkv.permute(0, 2, 1, 3, 4))
    with pytest.raises(ValueError, match=r"\[B, S, 3, H, D\]"):
        torch_attention.flash_attention_qkv(qkv[:, :, 0])


@pytest.mark.parametrize("head_dim,seq", [(16, 200), (32, 130), (64, 300), (128, 260)])
def test_bf16_exp_plain_version_walks_the_kernels_key_tiles(head_dim, seq):
    """The plain version takes the running max over ``KEY_TILE[head_dim]`` keys
    at a time, as the kernel of that head_dim does; whatever the tile, it
    stays within the 2e-2 bar of the JAX reference."""
    import jax.numpy as jnp

    assert torch_attention.KEY_TILE == {16: 64, 32: 64, 64: 128, 128: 128}
    q, k, v = _qkv((1, 2, seq, head_dim), seed=11)
    ours = torch_attention.attention_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), bf16_exp=True)
    ref = np.asarray(jax_attention.attention_reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), seq_len=seq).astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=2e-2, rtol=0)
