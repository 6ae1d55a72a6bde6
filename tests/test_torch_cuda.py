"""Tests of the port that need an NVIDIA GPU with nvcc (marker ``cuda``).

They skip wherever no CUDA device is visible. This file imports no JAX, so
it runs on the GPU machine, which has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each kernel is held against its plain version on the card, and the engine
on the card against the engine on the CPU. Tolerances: flash attention bf16
1e-2 (outputs are O(1) and one bf16 ulp at 1.0 is 7.8e-3), fp32 1e-5 (the
same math summed in another order); normalize_u8 fp32 1e-5, bf16 one ulp
of the largest output (|y| < 4: 2^-6); bottleneck_chain bf16 two ulps of the
largest output (|y| < 4: 2^-5), one for a sum that lands on the other side
of a rounding tie at the output and one for such flips of ``a`` and
``cmid`` carried forward, and a mean error below 1e-3 (the flips are few).
"""

import numpy as np
import pytest
import torch

from ics_tpu_torch.runtime.decode import stage_batch
from ics_tpu_torch.ops import LAUNCHES
from ics_tpu_torch.ops import attention, bottleneck, normalize
from ics_tpu_torch.ops.preproc import normalize_only


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


def make_chain(n, c, cm, seed, device):
    """Random packed chain weights, scaled so the chain's output stays below 4."""
    g = torch.Generator().manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    packed = {
        "w1": (randn(n, c, cm) * (2.0 / c) ** 0.5).bfloat16(),
        "w2": (randn(n, 9 * cm, cm) * (2.0 / (9 * cm)) ** 0.5).bfloat16(),
        "w3": (randn(n, cm, c) * 0.25 * (1.0 / cm) ** 0.5).bfloat16(),
    }
    for i, width in ((1, cm), (2, cm), (3, c)):
        packed[f"s{i}"] = 1.0 + 0.1 * randn(n, 1, width)
        packed[f"b{i}"] = 0.1 * randn(n, 1, width)
    return {k: v.to(device) for k, v in packed.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cm,n", [
    ((4, 56, 56, 256), 64, 2), ((4, 28, 28, 512), 128, 3), ((2, 7, 7, 256), 64, 2),
    ((1, 14, 14, 1024), 256, 1), ((1, 9, 5, 128), 64, 1),
])
def test_bottleneck_chain_kernel_matches_plain_version(cuda_device, shape, cm, n):
    packed = make_chain(n, shape[-1], cm, 0, cuda_device)
    x = (0.5 * torch.randn(shape, generator=torch.Generator().manual_seed(1))
         ).bfloat16().to(cuda_device)
    before = LAUNCHES["bottleneck_chain"].value
    out = bottleneck.bottleneck_chain(x, packed)
    torch.cuda.synchronize()
    assert LAUNCHES["bottleneck_chain"].value == before + n     # one launch per bottleneck
    ref = bottleneck.bottleneck_chain_reference(x, packed)
    diff = (out.float() - ref.float()).abs()
    assert ref.float().abs().max().item() < 4
    assert diff.max().item() <= 2.0 ** -5 and diff.mean().item() < 1e-3
    # every tiling gives the same function
    other = bottleneck.bottleneck_chain(x, packed, tile_rows=1 if shape[1] > 14 else 2)
    assert (other.float() - ref.float()).abs().max().item() <= 2.0 ** -5


@pytest.mark.cuda
def test_bottleneck_chain_kernel_zero_border_with_large_bias(cuda_device):
    packed = make_chain(2, 256, 64, 3, cuda_device)
    packed["b1"] = packed["b1"] + 2.0       # relu(b1) on the padding ring would show
    packed["w2"] = (packed["w2"].float() * 0.3).bfloat16()
    x = (0.5 * torch.randn((2, 12, 12, 256), generator=torch.Generator().manual_seed(4))
         ).bfloat16().to(cuda_device)
    out = bottleneck.bottleneck_chain(x, packed, tile_rows=5)
    ref = bottleneck.bottleneck_chain_reference(x, packed)
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= 2.0 ** -7 * scale


@pytest.mark.cuda
def test_bottleneck_chain_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    packed = make_chain(1, 256, 64, 0, cuda_device)
    x = torch.zeros((1, 8, 8, 256), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        bottleneck.bottleneck_chain(x.float(), packed)
    with pytest.raises(ValueError, match="contiguous"):
        bottleneck.bottleneck_chain(x.transpose(1, 2), packed)
    with pytest.raises(ValueError, match="one device"):
        bottleneck.bottleneck_chain(x, {k: v.cpu() for k, v in packed.items()})
    with pytest.raises(ValueError, match="Cm in"):
        bottleneck.bottleneck_chain(x[..., :128].contiguous(), make_chain(1, 128, 32, 0, cuda_device))
    with pytest.raises(ValueError, match="tile_rows"):
        bottleneck.bottleneck_chain(x, packed, tile_rows=9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2.0 ** -6), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape,canvas", [
    ((4, 384, 384), 512), ((2, 224, 224), None), ((1, 7, 13), None), ((3, 64, 64), 66),
])
def test_normalize_u8_kernel_matches_plain_version(cuda_device, dtype, tol, shape, canvas):
    b, h, w = shape
    g = torch.Generator().manual_seed(2)
    full = torch.randint(0, 256, (b, canvas or h, canvas or w, 3), generator=g,
                         dtype=torch.uint8).to(cuda_device)
    x = full[:, :h, :w]
    before = LAUNCHES["normalize_u8"].value
    out = normalize.normalize_u8(x, dtype=dtype)
    torch.cuda.synchronize()
    assert LAUNCHES["normalize_u8"].value == before + 1
    assert out.is_contiguous() and out.dtype == dtype
    ref = normalize_only(x, dtype=dtype)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_resnet_engine_on_the_card_with_chains_matches_the_engine_on_the_cpu(cuda_device):
    import ics_tpu_torch.models.registry as registry
    from ics_tpu_torch.models import resnet
    from ics_tpu_torch.runtime.engine import InferenceEngine

    spec = registry.ModelSpec(
        "resnet_2211", lambda num_classes, device=None: resnet.ResNet(
            (2, 2, 1, 1), num_classes, device=device), 64, 64, dev_only=True)
    registry._REGISTRY[spec.name] = spec
    try:
        rng = np.random.default_rng(0)
        images = [rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in range(3)]
        canvas, sizes = stage_batch(images, canvas=None)
        kw = dict(num_classes=10, precision="bf16", buckets=(4,), canvas=256, seed=3,
                  fused_chains=True)
        ref_idx, ref_scores = InferenceEngine(spec.name, device="cpu", **kw).predict_staged(
            canvas, sizes)
        eng = InferenceEngine(spec.name, device=cuda_device, **kw)
        before = {k: c.value for k, c in LAUNCHES.items()}
        idx, scores = eng.predict_staged(canvas, sizes)
    finally:
        del registry._REGISTRY[spec.name]
    assert LAUNCHES["bottleneck_chain"].value == before["bottleneck_chain"] + 2
    assert LAUNCHES["normalize_u8"].value == before["normalize_u8"] + 1   # fixed-size lane
    np.testing.assert_array_equal(idx[:, 0], ref_idx[:, 0])
    np.testing.assert_allclose(scores, ref_scores, atol=2e-2, rtol=0)
    assert eng.status()["fused_chains"] is True
