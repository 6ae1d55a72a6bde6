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
``cmid`` carried forward, and a mean error below 1e-3 (the flips are few);
depthwise_conv fp32 1e-5 times the largest output (the same k*k fp32 products
summed in another order), bf16 one ulp of the largest output (|y| < 8: 2^-5,
the two fp32 sums on the two sides of a rounding tie); window_attention and
window_attention_qkv bf16 1e-2 and fp32 1e-5 as flash attention (outputs
O(1)); flash attention with
``bf16_exp`` 2e-2 (each p within 2^-7 relative of the plain version's, the
bound of ``ex2.approx.ftz.bf16x2``, on top of the bf16 bar). The same bars
hold for strided views of a fused qkv product and for ``flash_attention_qkv``.
The device decode of the JPEG-coefficient lanes (plain PyTorch, fp32, TF32
off) on the card against the same call on the CPU: within 1 LSB on at most
0.1 % of the canvas; the fused coefficient step's top-5 equal and scores
within atol 2e-4, rtol 1e-4 of its CPU run. The embed step of ResNet-50 in
bf16 through the chain kernel against its fp32 plain path on the card:
1 - cosine at most 3e-5 (bf16 activations through 50 layers; the bar
``chip_smoke.py`` phase 7 sets between its measured spread and the nearest
other image), and each served vector nearest its own image's plain one
(with random weights the images' vectors lie close together); the embedding
index's top-k on the card against the CPU: the same order, scores within
1e-5 (fp32 sums of the same bf16 products in another order). The backward
passes of the explain step against autograd of their plain versions: the
largest error at most 1e-4 (fp32) and 2e-2 (bf16) of the largest gradient,
the same bars as ``chip_smoke.py`` phase 8; explain on the card, kernel path
against plain path in fp32: the same top-k, heat maps within 1e-4.
DenseNet-121 and RegNet-Y 400MF in bf16 against fp32 on the card: the top-1
equal wherever the fp32 margin exceeds twice the largest deviation, and no
kernel of the port launched; a pretrained file written by ``save_npz`` and
loaded onto the card: the seeded engine's logits exactly.
"""

import numpy as np
import pytest
import torch

from ics_tpu_torch.runtime.decode import stage_batch
from ics_tpu_torch.ops import LAUNCHES
from ics_tpu_torch.ops import attention, bottleneck, depthwise, normalize, window_attention
from ics_tpu_torch.ops.preproc import normalize_only


@pytest.fixture()
def anyio_backend():
    return "asyncio"


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


def _strided_case(device, shape, dtype, seq_len, bf16_exp=False):
    """q, k, v as strided views of one [B + 1, S, 3, H, D] tensor, as ViT's
    fused qkv product lies. The image behind the last one and the K and V rows
    at or past ``seq_len`` are NaN: the kernel must not read them (a zero
    weight times NaN would show). Returns the kernel's outputs through both
    entry points, twice each (a missing fence shows only sometimes), and the
    plain version's on contiguous copies with those rows zeroed."""
    b, h, s, d = shape
    g = torch.Generator(device=device).manual_seed(s * 131 + d)
    store = torch.randn((b + 1, s, 3, h, d), generator=g, device=device).to(dtype)
    store[b:] = float("nan")
    qkv = store[:b]
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    clean_k, clean_v = k.contiguous(), v.contiguous()
    if seq_len is not None:
        k[:, :, seq_len:] = float("nan")
        v[:, :, seq_len:] = float("nan")
        clean_k[:, :, seq_len:] = 0
        clean_v[:, :, seq_len:] = 0
    ref = attention.attention_reference(q.contiguous(), clean_k, clean_v, seq_len, bf16_exp)
    outs = []
    for _ in range(2):
        outs.append(attention.flash_attention(q, k, v, seq_len, bf16_exp))
        outs.append(attention.flash_attention_qkv(qkv, seq_len, bf16_exp).transpose(1, 2))
    torch.cuda.synchronize()
    return outs, ref


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("seq", [1, 63, 64, 65, 127, 128, 129, 577, 1100])
def test_kernel_at_the_tile_edges_on_strided_views(cuda_device, seq, head_dim):
    """Sequence lengths on both sides of the 64-row and 128-key tile edges,
    through ``flash_attention`` on strided views and ``flash_attention_qkv``."""
    before = LAUNCHES["flash_attention"].value
    outs, ref = _strided_case(cuda_device, (2, 3, seq, head_dim), torch.bfloat16, None)
    assert LAUNCHES["flash_attention"].value == before + 4
    for out in outs:
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        assert (out.float() - ref.float()).abs().max().item() <= 1e-2
        assert torch.equal(out, outs[0])


_MASKED_BF16 = [((2, 3, 577, d), torch.bfloat16, n) for d in (64, 128) for n in (0, 1, 300, 577)]
_MASKED_BF16 += [((2, 3, 130, 16), torch.bfloat16, 70), ((2, 3, 130, 32), torch.bfloat16, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,seq_len,bf16_exp", [
    *((*case, False) for case in _MASKED_BF16), *((*case, True) for case in _MASKED_BF16),
    ((2, 3, 130, 64), torch.float32, 100, False), ((1, 2, 200, 128), torch.float32, 0, False),
])
def test_kernel_never_reads_behind_seq_len_or_the_last_image(cuda_device, shape, dtype,
                                                             seq_len, bf16_exp):
    """NaN in the K and V rows at or past ``seq_len`` and in the memory behind
    the last image: the output is finite and within tolerance, and fully
    masked rows are exact zeros, in the [B, S, H, D] layout too."""
    outs, ref = _strided_case(cuda_device, shape, dtype, seq_len, bf16_exp)
    tol = (2e-2 if bf16_exp else 1e-2) if dtype == torch.bfloat16 else 1e-5
    for out in outs:
        assert bool(torch.isfinite(out).all())
        assert (out.float() - ref.float()).abs().max().item() <= tol
        assert torch.equal(out, outs[0])
        if seq_len == 0:
            assert bool((out == 0).all())


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros((1, 2, 8, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        attention.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((1, 2, 8, 48), device=cuda_device, dtype=torch.bfloat16)
        attention.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="last dimension contiguous"):
        t = torch.zeros((1, 2, 64, 8), device=cuda_device, dtype=torch.bfloat16).transpose(2, 3)
        attention.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        wide = torch.zeros((1, 2, 8, 68), device=cuda_device, dtype=torch.bfloat16)
        attention.flash_attention(wide[..., :64], q, q)          # rows 136 bytes apart
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        flat = torch.zeros(1 * 2 * 8 * 64 + 4, device=cuda_device, dtype=torch.bfloat16)
        attention.flash_attention(flat[4:].view(1, 2, 8, 64), q, q)   # base 8 bytes off
    with pytest.raises(ValueError, match="one CUDA device"):
        attention.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match=r"\[B, S, 3, H, D\]"):
        attention.flash_attention_qkv(q)
    # a transposed [B, S, H, D] tensor is a strided view the kernel takes
    t = torch.randn((1, 8, 2, 64), device=cuda_device).bfloat16().transpose(1, 2)
    out = attention.flash_attention(t, t, t)
    ref = attention.attention_reference(t.contiguous(), t.contiguous(), t.contiguous())
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2


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
    # the tiling depends on the batch: both ResNet-50 chains at the serving buckets
    ((1, 56, 56, 256), 64, 2), ((8, 56, 56, 256), 64, 2), ((32, 56, 56, 256), 64, 2),
    ((1, 28, 28, 512), 128, 3), ((8, 28, 28, 512), 128, 3), ((32, 28, 28, 512), 128, 3),
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


# ---- depthwise_conv ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,k,bias", [
    ((4, 56, 56, 96), 7, True), ((4, 28, 28, 192), 7, True), ((4, 14, 14, 384), 7, True),
    ((4, 7, 7, 768), 7, True), ((2, 28, 28, 88), 3, False), ((2, 14, 14, 240), 5, True),
    ((2, 12, 12, 2688), 5, False), ((3, 1, 1, 16), 3, True), ((2, 9, 13, 24), 5, False),
    ((2, 10, 6, 15), 3, True),       # odd C: the direct kernel
    ((1, 11, 11, 32), 9, True),      # k beyond the tile kernel's: the direct kernel
])
def test_depthwise_kernel_matches_plain_version(cuda_device, dtype, shape, k, bias):
    g = torch.Generator().manual_seed(shape[-1] + k)
    x = torch.randn(shape, generator=g).to(dtype).to(cuda_device)
    w = (torch.randn((k, k, shape[-1]), generator=g) / k).to(dtype).to(cuda_device)
    b = torch.randn(shape[-1], generator=g).to(dtype).to(cuda_device) if bias else None
    before = LAUNCHES["depthwise_conv"].value
    out = depthwise.depthwise_conv(x, w, b)
    torch.cuda.synchronize()
    assert LAUNCHES["depthwise_conv"].value == before + 1
    ref = depthwise.depthwise_reference(x, w, b)
    top = ref.float().abs().max().item()
    assert top < 8
    tol = 2.0 ** -5 if dtype == torch.bfloat16 else 1e-5 * max(top, 1.0)
    assert out.shape == ref.shape and out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= tol
    # the module's OIHW weight, plain and as fold() stores it, is the same function
    oihw = w.permute(2, 0, 1).reshape(shape[-1], 1, k, k).contiguous()
    for taps in (oihw, oihw.contiguous(memory_format=torch.channels_last)):
        again = depthwise.depthwise_conv(x, taps, b)
        assert torch.equal(again, out)


@pytest.mark.cuda
def test_depthwise_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((1, 8, 8, 16), device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 16), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        depthwise.depthwise_conv(x.half(), w.half())
    with pytest.raises(ValueError, match="one dtype"):
        depthwise.depthwise_conv(x, w.float())
    with pytest.raises(ValueError, match="contiguous"):
        depthwise.depthwise_conv(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="one CUDA device"):
        depthwise.depthwise_conv(x, w.cpu())
    with pytest.raises(ValueError, match="odd k"):
        depthwise.depthwise_conv(x, torch.zeros((2, 2, 16), device=cuda_device,
                                                dtype=torch.bfloat16))


@pytest.mark.cuda
def test_depthwise_conv2d_module_launches_the_kernel_only_within_its_contract(cuda_device):
    from ics_tpu_torch.nn.layers import Conv2D, set_use_kernels

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 14, 14, 32), generator=g).bfloat16().to(cuda_device)
    for stride, launches in ((1, 1), (2, 0)):
        conv = Conv2D(32, 32, 5, stride, padding=2, groups=32, use_bias=False)
        conv.reset_parameters(g)
        conv = conv.to(cuda_device)
        before = LAUNCHES["depthwise_conv"].value
        with torch.inference_mode():
            out = conv(x)
            assert LAUNCHES["depthwise_conv"].value == before + launches
            library = set_use_kernels(conv, False)(x)
            assert LAUNCHES["depthwise_conv"].value == before + launches
        assert (out.float() - library.float()).abs().max().item() <= 2.0 ** -5


# ---- the redesigned kernels at the edges of their tiles ------------------------------

def _dw_inputs(shape, k, bias, dtype, device, scale=1.0):
    g = torch.Generator().manual_seed(shape[-1] * 7 + k)
    x = (scale * torch.randn(shape, generator=g)).to(dtype)
    w = (torch.randn((k, k, shape[-1]), generator=g) / k).to(dtype).to(device)
    b = torch.randn(shape[-1], generator=g).to(dtype).to(device) if bias else None
    # x is the middle of a tensor of NaN: a read outside x would reach a result
    store = torch.full((shape[0] + 2, *shape[1:]), float("nan"), dtype=dtype, device=device)
    store[1:-1] = x.to(device)
    return store[1:-1], w, b


def _dw_check(x, w, b, **kw):
    runs = [depthwise.depthwise_conv(x, w, b, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    ref = depthwise.depthwise_reference(x, w, b)
    top = ref.float().abs().max().item()
    tol = 2.0 ** -5 if x.dtype == torch.bfloat16 else 1e-5 * max(top, 1.0)
    assert top < 8 and bool(torch.isfinite(runs[0]).all())
    assert (runs[0].float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(runs[0], runs[1])                       # twice, bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("threads", ["wide", "narrow"])
@pytest.mark.parametrize("h,w", [(7, 9), (8, 8), (9, 7), (8, 6), (16, 17), (2, 3), (1, 1)])
def test_strip_kernel_on_both_sides_of_its_block_edges(cuda_device, dtype, k, threads, h, w):
    """Blocks of 8 columns (7 with 7 columns a thread) and 8 rows on images one
    under, at and one over them, two blocks and a bit, and smaller than k, with
    the wide and with the narrow thread shape."""
    x, wt, b = _dw_inputs((2, h, w, 8), k, True, dtype, cuda_device)
    ch, cols = depthwise.STRIP_SHAPES[(x.element_size(), k)][threads == "narrow"]
    tw = min(max(8 // cols, 1), -(-w // cols))
    geometry = (ch, cols, 8 // ch, tw, min(8, h))            # all 8 channels in one block
    before = LAUNCHES["depthwise_conv"].value
    if depthwise.strip_fits(geometry, k, x.element_size()):
        _dw_check(x, wt, b, variant="strip", geometry=geometry)
    else:   # too narrow for a block's copy plan at the larger k: whatever serves the shape
        with pytest.raises(ValueError, match="geometry"):
            depthwise.depthwise_conv(x, wt, b, variant="strip", geometry=geometry)
        _dw_check(x, wt, b)
    assert LAUNCHES["depthwise_conv"].value == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,bias,geometry", [
    ((2, 9, 11, 24), 3, True, None), ((2, 9, 11, 40), 5, False, None),
    ((2, 9, 11, 88), 7, True, None),
    ((2, 9, 11, 88), 3, False, (8, 1, 8, 11, 5)),        # a last channel block that is part empty
    ((2, 9, 11, 88), 3, False, (4, 4, 16, 3, 5)),
    ((2, 9, 11, 40), 7, True, (2, 1, 16, 4, 9)),
    ((2, 9, 11, 40), 7, True, (1, 7, 32, 2, 9)),
    ((5, 9, 11, 24), 5, False, (4, 1, 6, 11, 9)),        # whole pixels of 24 channels a block
    ((5, 9, 11, 24), 5, False, (2, 4, 12, 3, 9)),
    ((5, 6, 6, 40), 7, True, (2, 1, 20, 6, 6)),
    ((3, 60, 60, 24), 3, False, None), ((2, 60, 60, 96), 7, True, None),
    ((16, 24, 24, 672), 3, False, None), ((16, 24, 24, 960), 5, False, None),   # served wide
    ((16, 56, 56, 96), 7, True, None),
])
def test_strip_kernel_channel_counts_and_part_empty_blocks(cuda_device, shape, k, bias, geometry):
    x, w, b = _dw_inputs(shape, k, bias, torch.bfloat16, cuda_device)
    _dw_check(x, w, b, variant="strip", geometry=geometry)
    _dw_check(x, w, b)                                # and whatever pick_plan serves


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [1, 8, 32])
@pytest.mark.parametrize("model", ["convnext_tiny", "mobilenetv3_small", "efficientnet_b4"])
def test_depthwise_kernel_at_every_served_call_of_a_model(cuda_device, model, bucket):
    """The kernel and its geometry depend on the batch (``pick_plan``): every
    depthwise call of a model's forward at each serving bucket, through
    whatever the wrapper takes there."""
    from ics_tpu_torch.tools.bench_depthwise import depthwise_calls

    for shape, k, bias in sorted(depthwise_calls(model, bucket)):
        # halved: among tens of millions of outputs of unit deviation one passes 8
        x, w, b = _dw_inputs(shape, k, bias, torch.bfloat16, cuda_device, scale=0.5)
        _dw_check(x, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,k,variant", [
    ((4, 14, 20, 48), 3, "tile"), ((4, 14, 20, 48), 5, "tile"), ((4, 14, 20, 48), 7, "tile"),
    ((2, 10, 6, 15), 5, "direct"), ((1, 11, 11, 32), 9, "direct"), ((2, 6, 5, 8), 3, "direct"),
])
def test_the_other_depthwise_kernels_hold_the_same_bar(cuda_device, dtype, shape, k, variant):
    x, w, b = _dw_inputs(shape, k, True, dtype, cuda_device)
    _dw_check(x, w, b, variant=variant)
    with pytest.raises(ValueError, match="variant"):
        depthwise.depthwise_conv(x, w, b, variant="no_such_kernel")


@pytest.mark.cuda
def test_module_taps_follow_the_weight_on_the_card(cuda_device):
    from ics_tpu_torch.nn.layers import Conv2D, set_use_kernels

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 12, 12, 24), generator=g).bfloat16().to(cuda_device)
    conv = Conv2D(24, 24, 3, 1, padding=1, groups=24, use_bias=True)
    conv.reset_parameters(g)
    conv = conv.to(cuda_device)
    other = Conv2D(24, 24, 3, 1, padding=1, groups=24, use_bias=True)
    other.reset_parameters(g)
    with torch.inference_mode():
        first = conv(x)
        conv.load_state_dict(other.state_dict())               # written in place
        second = conv(x)
        library = set_use_kernels(conv, False)(x)
    assert not torch.equal(first, second)
    assert (second.float() - library.float()).abs().max().item() <= 2.0 ** -5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cm,n,tile_rows", [
    ((3, 9, 13, 256), 64, 1, None),        # H * W = 117: no multiple of an M tile
    ((2, 14, 14, 512), 128, 2, 4),         # a short last tile of 2 rows
    ((2, 30, 20, 256), 64, 3, 7),          # five passes of the first 1x1, last tile 2 rows
    ((1, 10, 9, 1024), 256, 2, 3),         # Cm 256, a short last tile
    ((2, 5, 40, 256), 64, 2, 1),           # one row a tile: both halo rows are other tiles'
])
def test_bottleneck_chain_variants_at_tile_edges(cuda_device, shape, cm, n, tile_rows):
    packed = make_chain(n, shape[-1], cm, 0, cuda_device)
    x = (0.5 * torch.randn(shape, generator=torch.Generator().manual_seed(1))
         ).bfloat16().to(cuda_device)
    # NaN around x: the x tile's rows above and below the image must be zeros
    store = torch.full((shape[0] + 2, *shape[1:]), float("nan"), dtype=torch.bfloat16,
                       device=cuda_device)
    store[1:-1] = x
    x = store[1:-1]
    runs = [bottleneck.bottleneck_chain(x, packed, tile_rows=tile_rows) for _ in range(2)]
    torch.cuda.synchronize()
    ref = bottleneck.bottleneck_chain_reference(x, packed)
    diff = (runs[0].float() - ref.float()).abs()
    assert bool(torch.isfinite(runs[0]).all()) and ref.float().abs().max().item() < 4
    assert diff.max().item() <= 2.0 ** -5 and diff.mean().item() < 1e-3
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_bottleneck_chain_wgmma_zero_border_with_large_bias_at_every_tiling(cuda_device):
    packed = make_chain(2, 256, 64, 3, cuda_device)
    packed["b1"] = packed["b1"] + 2.0
    packed["w2"] = (packed["w2"].float() * 0.3).bfloat16()
    x = (0.5 * torch.randn((2, 12, 12, 256), generator=torch.Generator().manual_seed(4))
         ).bfloat16().to(cuda_device)
    ref = bottleneck.bottleneck_chain_reference(x, packed)
    scale = max(1.0, ref.float().abs().max().item())
    for tile_rows in (1, 5, 12):
        out = bottleneck.bottleneck_chain(x, packed, tile_rows=tile_rows)
        assert (out.float() - ref.float()).abs().max().item() <= 2.0 ** -7 * scale


@pytest.mark.cuda
@pytest.mark.anyio
@pytest.mark.parametrize("name", ["resnet18"])
async def test_modelo_without_a_chain_path_is_served_on_the_card_under_fused_chains(
        cuda_device, tmp_path, name):
    """``TPU_FUSED_CHAINS=true`` with ``?modelo=resnet18``: 200 from the card,
    without chains, where the pool used to answer 500."""
    import io

    import httpx
    from PIL import Image

    from ics_tpu_torch.core.config import settings
    from ics_tpu_torch.db.engine import Database
    from ics_tpu_torch.main import create_app
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.runtime.service import InferenceService, InferenceServicePool

    kw = dict(num_classes=10, precision="bf16", buckets=(1,), canvas=256, fused_chains=True)
    service = InferenceService(InferenceEngine("resnet_tiny", device=cuda_device, **kw))
    await service.start()
    app = create_app(db=Database(f"sqlite:///{tmp_path}/cuda_app.db"))
    app.state.engine = service
    app.state.engine_pool = InferenceServicePool("resnet_tiny", device=cuda_device, **kw)
    app.state.engine_pool.add("resnet_tiny", service)
    await app.startup()
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (64, 64, 3), np.uint8)).save(
        buf, "PNG")
    try:
        async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                     base_url="http://test") as client:
            r = await client.post("/auth/login", data={
                "username": settings.ADMIN_EMAIL, "password": settings.ADMIN_SENHA})
            client.cookies.clear()
            h = {"Authorization": f"Bearer {r.json()['access_token']}"}
            r = await client.post(f"/inferencia/classificar?modelo={name}", headers=h,
                                  files=[("files", ("a.png", buf.getvalue(), "image/png"))])
            assert r.status_code == 200, r.text
            st = (await client.get(f"/inferencia/status?modelo={name}", headers=h)).json()
            assert st["backend"] == "cuda" and st["fused_chains"] is False
    finally:
        await app.state.engine_pool.stop()
        await app.shutdown()
        await service.stop()


# ---- window_attention -------------------------------------------------------------

def _window_inputs(bn, heads, ww, hd, n_w, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((bn, heads, ww, hd), generator=g).to(dtype).to(device)
               for _ in range(3))
    q = q * hd ** -0.5
    bias = torch.randn((heads, ww, ww), generator=g).to(device)
    mask = None
    if n_w:
        cut = torch.rand((n_w, ww, ww), generator=g) < 0.3
        cut &= ~torch.eye(ww, dtype=torch.bool)       # a query always sees itself
        mask = torch.where(cut, -1e4, 0.0).to(torch.float32).to(device)
    return q, k, v, bias, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("bn,heads,ww,hd,n_w", [
    (128, 3, 49, 32, 64), (64, 6, 49, 32, 16), (16, 12, 49, 32, 4), (4, 24, 49, 32, 0),
    (128, 3, 49, 32, 0), (8, 2, 16, 16, 4), (8, 4, 16, 16, 0), (3, 2, 64, 32, 3),
    (2, 1, 1, 16, 0), (6, 4, 33, 16, 2),
])
def test_window_attention_kernel_matches_plain_version(cuda_device, dtype, tol, bn, heads,
                                                       ww, hd, n_w):
    q, k, v, bias, mask = _window_inputs(bn, heads, ww, hd, n_w, dtype, cuda_device)
    before = LAUNCHES["window_attention"].value
    out = window_attention.window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert LAUNCHES["window_attention"].value == before + 1
    ref = window_attention.window_attention_reference(q, k, v, bias, mask)
    assert out.shape == ref.shape and out.dtype == dtype
    assert bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_window_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q, k, v, bias, mask = _window_inputs(4, 2, 16, 16, 2, torch.bfloat16, cuda_device)
    attend = window_attention.window_attention
    with pytest.raises(ValueError, match="bf16 or fp32"):
        attend(q.half(), k.half(), v.half(), bias, mask)
    with pytest.raises(ValueError, match="fp32 bias and mask"):
        attend(q, k, v, bias.bfloat16(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        attend(q, k.transpose(0, 1).contiguous().transpose(0, 1), v, bias, mask)
    with pytest.raises(ValueError, match="one CUDA device"):
        attend(q, k, v, bias.cpu(), mask)
    x = torch.zeros((2, 2, 16, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attend(x, x, x, bias)
    big = torch.zeros((1, 1, 81, 16), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 64"):
        attend(big, big, big, torch.zeros((1, 81, 81), device=cuda_device))


def _qkv_case(batch, grid, heads, hd, window, shift, dtype, device, seed=0, nan_image=False):
    """Random qkv [B, G, G, 3, H, hd] with Swin's table, index and shift mask.
    ``nan_image``: the qkv product is a view of one with an image of NaN
    behind the last one and NaN in 8 padding channels of every token."""
    from ics_tpu_torch.models.swin import _relative_position_index, _shift_attn_mask

    g = torch.Generator().manual_seed(seed)
    c3 = 3 * heads * hd
    store = torch.randn((batch + 1, grid, grid, c3 + 8), generator=g).to(dtype)
    if nan_image:
        store[batch:] = float("nan")
        store[..., c3:] = float("nan")
    qkv = store.to(device)[:batch, ..., :c3].unflatten(-1, (3, heads, hd))
    table = torch.randn(((2 * window - 1) ** 2, heads), generator=g).to(device)
    index = torch.from_numpy(_relative_position_index(window)).to(device)
    mask = (torch.from_numpy(_shift_attn_mask(grid, window, shift)).to(device)
            if shift else None)
    return qkv, table, index, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("batch,grid,heads,hd,window,shift", [
    # every Swin-T call at bucket 1 and 8, shifted where the grid has more than one window
    (1, 56, 3, 32, 7, 0), (1, 56, 3, 32, 7, 3), (1, 28, 6, 32, 7, 3), (1, 14, 12, 32, 7, 3),
    (1, 7, 24, 32, 7, 0), (8, 56, 3, 32, 7, 3), (8, 28, 6, 32, 7, 0), (8, 14, 12, 32, 7, 3),
    (8, 7, 24, 32, 7, 0),
    (4, 16, 2, 16, 4, 2), (4, 8, 4, 16, 4, 0),        # swin_micro: ww 16, hd 16
    (3, 10, 2, 16, 5, 2), (2, 9, 2, 32, 3, 1),        # ww 25 and 9: no multiple of 8
    (2, 16, 1, 32, 8, 4),                             # ww 64, the most a window may have
])
def test_window_attention_qkv_kernel_matches_plain_version(cuda_device, dtype, tol, batch, grid,
                                                           heads, hd, window, shift):
    qkv, table, index, mask = _qkv_case(batch, grid, heads, hd, window, shift, dtype,
                                        cuda_device, nan_image=True)
    before = LAUNCHES["window_attention"].value
    runs = [window_attention.window_attention_qkv(qkv, table, index.to(torch.int16), mask,
                                                  window, shift, hd ** -0.5) for _ in range(2)]
    torch.cuda.synchronize()
    assert LAUNCHES["window_attention"].value == before + 2
    ref = window_attention.window_attention_qkv_reference(
        qkv, table, index, mask, window, shift, hd ** -0.5)
    out = runs[0]
    assert out.shape == ref.shape == (batch, grid, grid, heads * hd) and out.dtype == dtype
    assert bool(torch.isfinite(out).all()) and torch.equal(runs[0], runs[1])
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_window_attention_qkv_every_head_group_gives_the_same_bits(cuda_device, monkeypatch):
    """How many heads a work item takes changes where a head is computed,
    never how: every head group gives the same output. The group is forced
    by replacing ``pick_head_group``; the kernel refuses one that does not
    divide the heads."""
    qkv, table, index, mask = _qkv_case(4, 16, 4, 16, 4, 2, torch.bfloat16, cuda_device)
    index = index.to(torch.int16)
    outs = []
    for group in (1, 2, 4, 3):
        monkeypatch.setattr(window_attention, "pick_head_group", lambda *a, g=group: g)
        if group == 3:
            with pytest.raises(RuntimeError, match="launch failed"):
                window_attention.window_attention_qkv(qkv, table, index, mask, 4, 2, 0.25)
        else:
            outs.append(window_attention.window_attention_qkv(qkv, table, index, mask, 4, 2,
                                                              0.25))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.cuda
def test_window_attention_qkv_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    qkv, table, index, mask = _qkv_case(2, 16, 2, 16, 4, 2, torch.bfloat16, cuda_device)
    index16 = index.to(torch.int16)
    attend = window_attention.window_attention_qkv
    with pytest.raises(ValueError, match="bf16 or fp32"):
        attend(qkv.half(), table, index16, mask, 4, 2, 0.25)
    with pytest.raises(ValueError, match="fp32 rel_table and mask"):
        attend(qkv, table.bfloat16(), index16, mask, 4, 2, 0.25)
    with pytest.raises(ValueError, match="int16 rel_index"):
        attend(qkv, table, index, mask, 4, 2, 0.25)
    with pytest.raises(ValueError, match="one CUDA device"):
        attend(qkv, table.cpu(), index16, mask, 4, 2, 0.25)
    with pytest.raises(ValueError, match="last dimension contiguous"):
        attend(qkv.transpose(4, 5).contiguous().transpose(4, 5), table, index16, mask, 4, 2,
               0.25)
    wide = torch.zeros((2, 16, 16, 3 * 2 * 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attend(wide.unflatten(-1, (3, 2, 64)), table, index16, mask, 4, 2, 0.25)
    odd = torch.zeros((2, 16, 16, 97), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        attend(odd[..., :96].unflatten(-1, (3, 2, 16)), table, index16, mask, 4, 2, 0.25)


# ---- flash attention, bf16 exp ----------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,seq_len", [
    ((2, 12, 577, 64), None), ((2, 12, 577, 64), 300), ((1, 3, 130, 32), None),
    ((1, 2, 100, 64), 0),
])
def test_flash_attention_bf16_exp_matches_plain_version(cuda_device, shape, seq_len):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).bfloat16()
               for _ in range(3))
    before = {name: LAUNCHES[name].value
              for name in ("flash_attention", "flash_attention_bf16_exp")}
    out = attention.flash_attention(q, k, v, seq_len, bf16_exp=True)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bf16_exp"].value == before["flash_attention_bf16_exp"] + 1
    assert LAUNCHES["flash_attention"].value == before["flash_attention"]
    ref = attention.attention_reference(q, k, v, seq_len, bf16_exp=True)
    exact = attention.attention_reference(q, k, v, seq_len)
    if seq_len == 0:
        assert bool((out == 0).all())
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (out.float() - exact.float()).abs().max().item() <= 3e-2
    with pytest.raises(ValueError, match="bf16_exp needs bf16"):
        attention.flash_attention(q.float(), k.float(), v.float(), bf16_exp=True)


# ---- the new models on the card ---------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name,kernel,launches", [
    ("swin_micro", "window_attention", 3),
    ("mobilenetv3_small", "depthwise_conv", 7),
])
def test_new_model_engines_on_the_card_match_the_engine_on_the_cpu(cuda_device, name, kernel,
                                                                   launches):
    from ics_tpu_torch.runtime.engine import InferenceEngine

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), np.uint8)
              for h, w in [(64, 64), (120, 90), (40, 200)]]
    canvas, sizes = stage_batch(images, canvas=None)
    kw = dict(num_classes=10, precision="fp32", buckets=(4,), canvas=256, seed=3)
    ref_idx, ref_scores = InferenceEngine(name, device="cpu", **kw).predict_staged(canvas, sizes)
    eng = InferenceEngine(name, device=cuda_device, **kw)
    before = LAUNCHES[kernel].value
    idx, scores = eng.predict_staged(canvas, sizes)
    assert LAUNCHES[kernel].value == before + launches
    np.testing.assert_array_equal(idx[:, 0], ref_idx[:, 0])
    np.testing.assert_allclose(scores, ref_scores, atol=1e-4, rtol=0)


# ---- the device-decode lane on the card ----------------------------------------------

def _jpeg(seed, h, w, mode="420", **kw) -> bytes:
    import io

    from PIL import Image, ImageFilter

    img = Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8))
    img = img.filter(ImageFilter.GaussianBlur(1))
    buf = io.BytesIO()
    if mode == "gray":
        img.convert("L").save(buf, "JPEG", quality=90, **kw)
    else:
        img.save(buf, "JPEG", quality=90, subsampling={"444": 0, "422": 1, "420": 2}[mode], **kw)
    return buf.getvalue()


@pytest.mark.cuda
@pytest.mark.parametrize("luma_blocks", [64, 128])
@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
def test_coeff_canvas_on_the_card_matches_the_cpu(cuda_device, mode, luma_blocks):
    """The same staged batch decoded on the card and on the CPU, fp32 with
    TF32 off: within 1 LSB on at most 0.1 % of the canvas."""
    from ics_tpu_torch import disable_tf32
    from ics_tpu_torch.native import imgcodec
    from ics_tpu_torch.runtime import device_decode

    disable_tf32()
    side = 8 * luma_blocks - 20
    blobs = [_jpeg(i, h, w, mode) for i, (h, w) in enumerate([(side, side - 100), (224, 224),
                                                               (97, 333)])]
    staged = device_decode.stage_coefficient_batch(
        [imgcodec.jpeg_coefficients(b) for b in blobs], luma_blocks=luma_blocks, mode=mode)
    on_cpu = device_decode.to_device(staged, "cpu")
    on_gpu = device_decode.to_device(staged, cuda_device)
    cpu = device_decode.decode_batch_to_canvas(on_cpu, mode=mode)
    gpu = device_decode.decode_batch_to_canvas(on_gpu, mode=mode).cpu()
    assert tuple(gpu.shape) == (3, 8 * luma_blocks, 8 * luma_blocks, 3)
    diff = (gpu - cpu).abs()
    assert diff.max().item() <= 1 and int((diff > 0).sum()) <= 1e-3 * diff.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["420", "gray"])
def test_fused_coeff_step_on_the_card_matches_the_cpu(cuda_device, mode):
    from ics_tpu_torch.native import imgcodec
    from ics_tpu_torch.runtime import device_decode
    from ics_tpu_torch.runtime.engine import InferenceEngine

    blobs = [_jpeg(10 + i, h, w, mode) for i, (h, w) in enumerate([(300, 400), (224, 224),
                                                                   (500, 375)])]
    staged = device_decode.stage_coefficient_batch(
        [imgcodec.jpeg_coefficients(b) for b in blobs], luma_blocks=64, mode=mode)
    kw = dict(num_classes=10, precision="fp32", buckets=(4,), canvas=256, seed=3)
    ref_idx, ref_scores = InferenceEngine("resnet_tiny", device="cpu", **kw).predict_coeff_staged(
        dict(staged), mode=mode)
    idx, scores = InferenceEngine("resnet_tiny", device=cuda_device, **kw).predict_coeff_staged(
        dict(staged), mode=mode)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(scores, ref_scores, atol=2e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.anyio
async def test_device_decode_lane_is_served_on_the_card(cuda_device):
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.runtime.service import InferenceService

    service = InferenceService(InferenceEngine("mobilenetv3_small", num_classes=10,
                                               buckets=(1, 4), device=cuda_device),
                               deadline_us=20_000)
    await service.start(warm=True)
    try:
        await service._lane_warm_task
        before = LAUNCHES["depthwise_conv"].value
        blobs = [_jpeg(0, 300, 400), _jpeg(1, 200, 240, "444"), _jpeg(2, 700, 600),
                 _jpeg(3, 120, 160, "gray")]
        outs = await service.classify_many(blobs)
        assert [o["decode"] for o in outs] == ["device:420", "device:444", "device:420",
                                              "device:gray"]
        st = service.status()
        assert st["backend"] == "cuda" and st["device_decoded"] == 4
        assert set(st["coeff_lanes"]) == {"420_512px", "444_512px", "420_1024px", "gray_512px"}
        assert LAUNCHES["depthwise_conv"].value - before == 7 * st["batches"]
    finally:
        await service.stop()


# ---- the embed step and the embedding index on the card ------------------------------

def _resnet50_pair(cuda_device):
    """ResNet-50 as served (bf16, the chain kernel) and its fp32 plain path,
    both on the card, on weights from one seed."""
    from ics_tpu_torch.runtime.engine import InferenceEngine

    kw = dict(num_classes=10, buckets=(1, 2), canvas=256, seed=5)
    served = InferenceEngine("resnet50", precision="bf16", fused_chains=True,
                             device=cuda_device, **kw)
    plain = InferenceEngine("resnet50", precision="fp32", device=cuda_device, **kw)
    return served, plain


@pytest.mark.cuda
def test_embed_step_in_bf16_through_the_chain_kernel_matches_the_fp32_plain_path(cuda_device):
    """Each served embedding within 1 - cosine 3e-5 of the fp32 plain path's
    of the same image and nearer it than any other image's, norms 1, and the
    chain kernel's 5 launches a step; the fp32 plain path launches no
    kernel."""
    served, plain = _resnet50_pair(cuda_device)
    rng = np.random.default_rng(0)
    shapes = [(224, 224), (300, 200), (160, 256), (256, 256), (200, 300), (180, 180)]
    images = [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in shapes]
    got, want = [], []
    for pair in (images[i:i + 2] for i in range(0, len(images), 2)):
        canvas, sizes = stage_batch(pair, canvas=None)
        before = {k: c.value for k, c in LAUNCHES.items()}
        got.append(served.embed_staged(canvas, sizes))
        assert LAUNCHES["bottleneck_chain"].value - before["bottleneck_chain"] == 5
        middle = {k: c.value for k, c in LAUNCHES.items()}
        want.append(plain.embed_staged(canvas, sizes))
        assert {k: c.value for k, c in LAUNCHES.items()} == middle
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape == (len(images), 2048)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    cos = got @ want.T
    own = 1.0 - np.diag(cos)
    assert own.max() <= 3e-5, own
    assert (np.argmax(cos, axis=1) == np.arange(len(images))).all(), 1.0 - cos


@pytest.mark.cuda
def test_embedding_index_top_k_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """The same stored corpus searched on the card and on the CPU: the same
    hashes in the same order (ties lower index first) and scores within
    1e-5 (fp32 sums of the same bf16 products in another order)."""
    from ics_tpu_torch.core import timezone as tz
    from ics_tpu_torch.crud.embedding_crud import upsert_embedding
    from ics_tpu_torch.db.engine import Database
    from ics_tpu_torch.db.models import ConjuntoImagens, Imagem
    from ics_tpu_torch.runtime.embedding_index import EmbeddingIndex

    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(700, 2048)).astype(np.float32)
    vecs[::7] = vecs[0]                     # ties: a hundred copies of one vector
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    db = Database(f"sqlite:///{tmp_path}/idx.db")
    db.create_all()
    now = tz.utcnow()
    with db.session() as s:
        cnj = ConjuntoImagens(nome_conj="i", caminho_conj="/i", file_id="1",
                              imagens_sincronizadas=True, data_proc=now, data_sinc=now)
        s.add(cnj)
        s.flush()
        for i, v in enumerate(vecs):
            h = f"{i:04d}" + "e" * 60
            s.add(Imagem(content_hash=h, nome_img=f"{i}.jpg", caminho_img=f"i/{i}.jpg",
                         data_proc=now, data_sinc=now, id_cnj=cnj.id_cnj))
            upsert_embedding(s, h, "m", v)
        s.commit()
    on_card, on_cpu = EmbeddingIndex(db, "m", device=cuda_device), EmbeddingIndex(db, "m",
                                                                                   device="cpu")
    for q in (vecs[0], vecs[3], -vecs[5]):
        got, want = on_card.search(q, k=64), on_cpu.search(q, k=64)
        assert [g["content_hash"] for g in got] == [w["content_hash"] for w in want]
        np.testing.assert_allclose([g["score"] for g in got], [w["score"] for w in want],
                                   atol=1e-5, rtol=0)
    assert on_card._matrix.device.type == "cuda" and on_card._matrix.shape == (1024, 2048)


@pytest.mark.cuda
def test_launch_counts_stay_exact_under_two_threads(cuda_device):
    """Classify-on-sync: the batcher's flush and the embed call drive one
    engine from two threads. Every step still launches the chain kernel 5
    times, and the counts add up to exactly 5 x (classify steps + embed
    steps); each thread's results equal a step run alone."""
    import threading

    served, _ = _resnet50_pair(cuda_device)
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 256, (240, 320, 3), np.uint8) for _ in range(2)]
    canvas, sizes = stage_batch(images, canvas=None)
    want_feats = served.embed_staged(canvas, sizes)
    want_idx, _ = served.predict_staged(canvas, sizes)
    rounds, errors, results = 20, [], {"embed": [], "classify": []}

    def work(kind):
        try:
            for _ in range(rounds):
                if kind == "embed":
                    results[kind].append(served.embed_staged(canvas, sizes))
                else:
                    results[kind].append(served.predict_staged(canvas, sizes)[0])
        except Exception as exc:  # surfaced below
            errors.append(exc)

    before = LAUNCHES["bottleneck_chain"].value
    threads = [threading.Thread(target=work, args=(kind,)) for kind in ("embed", "classify")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert LAUNCHES["bottleneck_chain"].value - before == 5 * 2 * rounds
    for feats in results["embed"]:
        np.testing.assert_array_equal(feats, want_feats)
    for idx in results["classify"]:
        np.testing.assert_array_equal(idx, want_idx)


# ---- the backward passes (explain): bars of chip_smoke.py phase 8 -------------------------
# largest |error| over max|ref|: fp32 1e-4 (fp32 sums in another order), bf16 2e-2 (the
# plain version rounds dP, dq and dk to bf16 where the kernels round once)

def _window_call(device, batch, grid, heads, hd, window, shift, dtype):
    from ics_tpu_torch.models.swin import _relative_position_index, _shift_attn_mask

    g = torch.Generator().manual_seed(grid + shift)
    qkv = torch.randn((batch, grid, grid, 3, heads, hd), generator=g).to(dtype).to(device)
    dout = torch.randn((batch, grid, grid, heads * hd), generator=g).to(dtype).to(device)
    table = torch.randn(((2 * window - 1) ** 2, heads), generator=g).to(device)
    index = torch.from_numpy(_relative_position_index(window)).to(torch.int16).to(device)
    mask = (torch.from_numpy(_shift_attn_mask(grid, window, shift)).to(device)
            if shift else None)
    return qkv, dout, table, index, mask


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("batch,grid,heads,hd,window,shift", [
    (2, 56, 3, 32, 7, 3), (2, 14, 12, 32, 7, 0), (3, 16, 2, 16, 4, 2), (2, 16, 1, 32, 8, 4)])
def test_window_backward_matches_autograd_of_the_plain_version(
        cuda_device, dtype, tol, batch, grid, heads, hd, window, shift):
    qkv, dout, table, index, mask = _window_call(cuda_device, batch, grid, heads, hd, window,
                                                 shift, dtype)
    before = LAUNCHES["window_attention_bwd"].value
    got = window_attention.window_attention_qkv_bwd(qkv, dout, table, index, mask, window,
                                                    shift, hd ** -0.5)
    ref = window_attention.window_attention_qkv_bwd_reference(qkv, dout, table, index, mask,
                                                              window, shift, hd ** -0.5)
    assert LAUNCHES["window_attention_bwd"].value == before + 1
    assert got.shape == qkv.shape and _rel(got, ref) <= tol
    # the same gradient through autograd of the served entry
    x = qkv.clone().requires_grad_()
    out = window_attention.window_attention_qkv(x, table, index, mask, window, shift, hd ** -0.5)
    assert out.grad_fn is not None
    (g,) = torch.autograd.grad(out, x, dout)
    assert torch.equal(g, got)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["depthwise_conv", "Conv2D"])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape,k", [((4, 56, 56, 96), 7), ((4, 24, 24, 672), 3),
                                     ((4, 14, 14, 240), 5), ((2, 9, 11, 15), 3)])
def test_depthwise_dx_matches_autograd_of_the_plain_version(cuda_device, dtype, tol, shape, k,
                                                            entry):
    """The input gradient through autograd of the kernel entry
    (``_DepthwiseConv``'s backward: one launch of the kernel on flipped taps)
    against autograd of the plain version; ``Conv2D`` is the served module,
    whose flipped taps are kept beside its taps."""
    from ics_tpu_torch.nn.layers import Conv2D

    g = torch.Generator().manual_seed(k)
    c = shape[-1]
    dy = torch.randn(shape, generator=g).to(dtype).to(cuda_device)
    w = (torch.randn((k, k, c), generator=g) / k).to(dtype).to(cuda_device)
    forward = lambda x: depthwise.depthwise_conv(x, w)   # noqa: E731
    if entry == "Conv2D":
        conv = Conv2D(c, c, k, 1, padding=k // 2, groups=c, use_bias=False)
        with torch.no_grad():
            conv.weight.copy_(w.float().permute(2, 0, 1).reshape(c, 1, k, k).cpu())
        forward = conv.to(device=cuda_device, dtype=dtype,
                          memory_format=torch.channels_last).requires_grad_(False)
    x = torch.zeros_like(dy, requires_grad=True)
    before = LAUNCHES["depthwise_conv_dx"].value
    (got,) = torch.autograd.grad(forward(x), x, dy)
    assert LAUNCHES["depthwise_conv_dx"].value == before + 1
    assert _rel(got, depthwise.depthwise_dx_reference(dy, w)) <= tol
    (again,) = torch.autograd.grad(forward(x), x, dy)
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_under_grad_no_kernel_entry_cuts_its_output_off(cuda_device):
    from ics_tpu_torch.nn.layers import Conv2D
    from ics_tpu_torch.ops import KernelHasNoGradient

    x = torch.randn((2, 8, 8, 16), device=cuda_device, requires_grad=True)
    conv = Conv2D(16, 16, 3, padding=1, groups=16)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    conv = conv.to(cuda_device)
    with pytest.raises(NotImplementedError, match="item 7"):
        conv(x)                                          # the weight asks for a gradient
    conv.requires_grad_(False)
    assert conv(x).grad_fn is not None
    qkv, _, table, index, mask = _window_call(cuda_device, 1, 8, 2, 16, 4, 2, torch.float32)
    with pytest.raises(NotImplementedError, match="item 7"):
        window_attention.window_attention_qkv(qkv, table.requires_grad_(), index, mask, 4, 2, 0.25)
    q = torch.randn((2, 2, 64, 64), device=cuda_device, requires_grad=True)
    with pytest.raises(KernelHasNoGradient):
        attention.flash_attention(q, q, q)
    q4 = torch.randn((2, 2, 16, 16), device=cuda_device, requires_grad=True)
    with pytest.raises(KernelHasNoGradient):
        window_attention.window_attention(q4, q4, q4, torch.zeros((2, 16, 16), device=cuda_device))
    with torch.no_grad():
        assert attention.flash_attention(q, q, q).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["swin_micro", "convnext_dev"])
def test_explain_on_the_card_kernel_path_against_plain_path(cuda_device, model):
    """fp32: the same top-k, heat maps within 1e-4, the forward and backward
    kernels launched once a layer on the kernel path and never on the plain
    path."""
    import ics_tpu_torch.models.registry as registry
    from ics_tpu_torch.models import convnext
    from ics_tpu_torch.nn.layers import set_use_kernels
    from ics_tpu_torch.ops import launch_counts, reset_launch_counts
    from ics_tpu_torch.runtime.engine import InferenceEngine

    registry._REGISTRY["convnext_dev"] = registry.ModelSpec(
        "convnext_dev", lambda num_classes, device=None: convnext.ConvNeXt(
            (1, 1, 1, 1), (16, 32, 64, 128), num_classes, device=device), 64, 64, dev_only=True)
    try:
        engine = InferenceEngine(model, num_classes=10, precision="fp32", buckets=(1,),
                                 canvas=64, device=cuda_device)
    finally:
        del registry._REGISTRY["convnext_dev"]
    for name, p in engine.model.named_parameters():
        if name.endswith("gamma"):
            p.data.fill_(0.5)
    engine.warmup()      # serving's steps first: operands cached under inference_mode
    rng = np.random.default_rng(0)
    canvas = rng.integers(0, 256, (1, 64, 64, 3), np.uint8)
    sizes = np.asarray([[56, 60]], np.int32)
    out = {}
    for on in (True, False):
        set_use_kernels(engine.model, on)
        reset_launch_counts()
        out[on] = engine.explain_staged(canvas, sizes, smooth_samples=4, seed=1)
        out[on, "launches"] = launch_counts()
    fwd, bwd = (("window_attention", "window_attention_bwd") if model == "swin_micro"
                else ("depthwise_conv", "depthwise_conv_dx"))
    assert out[True, "launches"][fwd] == out[True, "launches"][bwd] > 0
    assert out[False, "launches"][fwd] == out[False, "launches"][bwd] == 0
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_allclose(out[True][2], out[False][2], atol=1e-4)


def _folded_logits(engine, canvas, sizes):
    staged = engine._to_device(canvas, sizes)
    with torch.inference_mode():
        return engine.model.apply_folded(engine._preprocess(*staged, False)).float().cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["densenet121", "regnet_y_400mf"])
def test_dense_and_regnet_bf16_engine_step_on_the_card_against_fp32(cuda_device, model):
    """The bf16 engine on the card against the fp32 engine on the card (seed
    0): finite logits, the top-1 equal on every image whose fp32 margin
    between its first two classes exceeds twice the largest deviation, the
    served step's top-k the logits' own, and no kernel of the port launched
    (none is on these paths)."""
    from ics_tpu_torch.ops import launch_counts, reset_launch_counts
    from ics_tpu_torch.runtime.engine import InferenceEngine

    rng = np.random.default_rng(4)
    canvas = rng.integers(0, 256, (8, 256, 256, 3), np.uint8)
    sizes = rng.integers(150, 257, (8, 2)).astype(np.int32)
    f32 = InferenceEngine(model, precision="fp32", buckets=(8,), canvas=256, device=cuda_device)
    b16 = InferenceEngine(model, precision="bf16", buckets=(8,), canvas=256, device=cuda_device)
    ref, got = _folded_logits(f32, canvas, sizes), _folded_logits(b16, canvas, sizes)
    assert torch.isfinite(got).all()
    dev = (got - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * dev
    assert decided.any()
    assert bool((got.argmax(-1) == ref.argmax(-1))[decided].all())
    reset_launch_counts()
    idx, _ = b16.predict_staged(canvas, sizes)
    assert not any(launch_counts().values())
    np.testing.assert_array_equal(idx[:, 0], got.argmax(-1).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["regnet_y_400mf", "densenet121"])
def test_a_pretrained_file_loads_onto_the_card(cuda_device, model, tmp_path):
    """The port's ``save_npz`` of a seeded model, loaded by ``load_pretrained``
    into an fp32 engine on the card, gives the seeded engine's logits
    exactly; and with a new head (``num_classes``) the backbone's features
    are the seeded model's."""
    from ics_tpu_torch.models.registry import get_model
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.train.pretrained import load_pretrained, save_npz

    seeded = get_model(model).build(num_classes=1000)
    seeded.init_weights(torch.Generator().manual_seed(0))
    save_npz(tmp_path / "w.npz", seeded.state_dict())
    _, state_dict = load_pretrained(model, tmp_path / "w.npz")
    rng = np.random.default_rng(1)
    canvas = rng.integers(0, 256, (4, 256, 256, 3), np.uint8)
    sizes = np.full((4, 2), 256, np.int32)
    kw = dict(precision="fp32", buckets=(4,), canvas=256, device=cuda_device)
    loaded = InferenceEngine(model, state_dict=state_dict, **kw)
    assert next(loaded.model.parameters()).is_cuda
    assert torch.equal(_folded_logits(loaded, canvas, sizes),
                       _folded_logits(InferenceEngine(model, seed=0, **kw), canvas, sizes))
    _, new_head = load_pretrained(model, tmp_path / "w.npz", num_classes=7, seed=3)
    engine = InferenceEngine(model, num_classes=7, state_dict=new_head, **kw)
    idx, scores = engine.predict_staged(canvas, sizes)
    assert idx.shape == (4, 5) and np.isfinite(scores).all()
