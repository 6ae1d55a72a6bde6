"""Tests of the port that need an NVIDIA GPU with nvcc (marker ``cuda``).

They skip wherever no CUDA device is visible. This file imports no JAX, so
it runs on the GPU machine, which has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The kernel is held against its plain version on the card (bf16 max abs
error 1e-2: outputs are O(1) and one bf16 ulp at 1.0 is 7.8e-3; fp32
1e-5: the same math summed in another order), and the engine on the card
against the engine on the CPU.
"""

import numpy as np
import pytest
import torch

from ics_tpu.runtime.decode import stage_batch
from ics_tpu_torch.ops import LAUNCHES
from ics_tpu_torch.ops import attention


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape,seq_len", [
    ((2, 12, 577, 64), None), ((2, 12, 577, 64), 300), ((1, 2, 1100, 128), None),
    ((2, 3, 130, 32), None), ((2, 3, 130, 16), None), ((1, 2, 100, 64), 0),
])
def test_kernel_matches_plain_version(cuda_device, dtype, tol, shape, seq_len):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    before = LAUNCHES["flash_attention"].value
    out = attention.flash_attention(q, k, v, seq_len)
    ref = attention.attention_reference(q, k, v, seq_len)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"].value == before + 1
    if seq_len == 0:
        assert bool((out == 0).all())
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros((1, 2, 8, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        attention.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((1, 2, 8, 48), device=cuda_device, dtype=torch.bfloat16)
        attention.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2)
        attention.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="one CUDA device"):
        attention.flash_attention(q, q.cpu(), q)


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_engine_on_the_cpu(cuda_device):
    from ics_tpu_torch.runtime.engine import InferenceEngine

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), np.uint8)
              for h, w in [(64, 64), (120, 90), (40, 200)]]
    canvas, sizes = stage_batch(images, canvas=None)
    kw = dict(num_classes=10, precision="fp32", buckets=(4,), canvas=256, seed=3)
    ref_idx, ref_scores = InferenceEngine("vit_tiny", device="cpu", **kw).predict_staged(
        canvas, sizes)
    eng = InferenceEngine("vit_tiny", device=cuda_device, **kw)
    before = LAUNCHES["flash_attention"].value
    idx, scores = eng.predict_staged(canvas, sizes)
    assert LAUNCHES["flash_attention"].value == before + 8   # one per block
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-4, rtol=0)
    assert eng.status()["backend"] == "cuda"
