"""The port's device-side JPEG back end (``ics_tpu_torch/ops/jpeg_decode.py``)
against the JAX package's (``ics_tpu/ops/jpeg_decode.py``) on the same
coefficients, at fp32 on the CPU: the iDCT within 1e-3 in pixel units, the
chroma upsampling and the colour conversion before rounding within 1e-4, the
uint8 images within 1 LSB on at most 0.1 % of their values; then the whole
decode against PIL at the reference tests' bars.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

from ics_tpu.native import imgcodec as ref_codec
from ics_tpu.ops import jpeg_decode as ref
from ics_tpu_torch.native import imgcodec
from ics_tpu_torch.ops import jpeg_decode as port

pytestmark = pytest.mark.skipif(not ref_codec.available(), reason="native imgcodec not built")

SUBSAMPLING = {"444": 0, "422": 1, "420": 2}
RATIOS = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}


def smooth_image(seed, h=120, w=160):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).filter(
        ImageFilter.GaussianBlur(2))


def encode(img, mode="420", quality=90, **kw) -> bytes:
    buf = io.BytesIO()
    if mode == "gray":
        img.convert("L").save(buf, "JPEG", quality=quality, **kw)
    else:
        img.save(buf, "JPEG", quality=quality, subsampling=SUBSAMPLING[mode], **kw)
    return buf.getvalue()


def lsb_check(got, want):
    """uint8 images: at most 1 LSB apart, on at most 0.1 % of the values."""
    diff = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1, diff.max()
    assert np.count_nonzero(diff) <= 1e-3 * diff.size, np.count_nonzero(diff)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_dct_basis_is_the_references():
    np.testing.assert_array_equal(port._dct_basis(), ref._dct_basis())


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("component", [0, 1])
def test_idct_plane_matches_jax(component, quality):
    co = imgcodec.jpeg_coefficients(encode(smooth_image(component), quality=quality))
    c = co.components[component]
    want = np.asarray(ref.idct_plane(jnp.asarray(c["coeffs"]), jnp.asarray(c["quant"])))
    got = port.idct_plane(t(c["coeffs"]), t(c["quant"].view(np.int16)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_idct_plane_is_batched_over_leading_dimensions():
    rng = np.random.default_rng(0)
    # planes within a few hundred of the pixel range, as a JPEG's are
    coeffs = rng.integers(-8, 8, (3, 4, 5, 64)).astype(np.int16)
    quant = rng.integers(1, 16, (3, 64)).astype(np.uint16)
    batched = port.idct_plane(t(coeffs), t(quant))
    for i in range(3):
        want = np.asarray(ref.idct_plane(jnp.asarray(coeffs[i]), jnp.asarray(quant[i])))
        np.testing.assert_allclose(batched[i].numpy(), want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("mode", sorted(RATIOS))
@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (32, 24)])
def test_upsample_chroma_matches_jax(shape, mode):
    plane = np.random.default_rng(1).uniform(-20, 280, shape).astype(np.float32)
    h, v = RATIOS[mode]
    want = np.asarray(ref.upsample_chroma(jnp.asarray(plane), h, v))
    got = port.upsample_chroma(t(plane), h, v)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _jax_ycbcr_unrounded(y, cb, cr):
    """The lines of ``ics_tpu.ops.jpeg_decode.ycbcr_to_rgb`` before its
    round and clip."""
    cb, cr = cb - 128.0, cr - 128.0
    return jnp.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb], -1)


def test_ycbcr_to_rgb_matches_jax_before_and_after_rounding():
    rng = np.random.default_rng(2)
    y, cb, cr = (rng.uniform(-10, 265, (48, 40)).astype(np.float32) for _ in range(3))
    want = np.asarray(_jax_ycbcr_unrounded(*map(jnp.asarray, (y, cb, cr))))
    got = port.ycbcr_to_rgb(t(y), t(cb), t(cr), rounded=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    rounded = port.ycbcr_to_rgb(t(y), t(cb), t(cr))
    lsb_check(rounded.to(torch.uint8), ref.ycbcr_to_rgb(*map(jnp.asarray, (y, cb, cr))).astype(
        jnp.uint8))
    # half-to-even, as jnp.round
    half = torch.tensor([0.5, 1.5, 2.5, -0.5])
    neutral = torch.full((4,), 128.0)
    assert port.ycbcr_to_rgb(half, neutral, neutral)[:, 0].tolist() == [0.0, 2.0, 2.0, 0.0]


@pytest.mark.parametrize("mode", sorted(RATIOS))
@pytest.mark.parametrize("size", [(120, 160), (37, 53)])
def test_decode_from_coefficients_matches_jax(mode, size):
    co = imgcodec.jpeg_coefficients(encode(smooth_image(3, *size), mode))
    yc, cbc, crc = co.components
    args = (yc["coeffs"], yc["quant"], cbc["coeffs"], cbc["quant"], crc["coeffs"], crc["quant"])
    want = ref.decode_from_coefficients(*map(jnp.asarray, args), width=co.width,
                                        height=co.height, samp=RATIOS[mode])
    got = port.decode_from_coefficients(*args, width=co.width, height=co.height,
                                        samp=RATIOS[mode], device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (*size, 3)
    lsb_check(got.numpy(), want)


def test_decode_grayscale_from_coefficients_matches_jax():
    co = imgcodec.jpeg_coefficients(encode(smooth_image(4, 50, 70), "gray"))
    c = co.components[0]
    want = ref.decode_grayscale_from_coefficients(
        jnp.asarray(c["coeffs"]), jnp.asarray(c["quant"]), width=co.width, height=co.height)
    got = port.decode_grayscale_from_coefficients(c["coeffs"], c["quant"], co.width, co.height,
                                                  device="cpu")
    assert tuple(got.shape) == (50, 70, 3)
    lsb_check(got.numpy(), want)


@pytest.mark.parametrize("case", ["444", "422", "420", "progressive", "gray"])
def test_decode_jpeg_device_matches_pil(case):
    """The reference tests' bars: mean error under 1, max at most 6 (gray 2)."""
    if case == "progressive":
        data = encode(smooth_image(5), "420", progressive=True)
    else:
        data = encode(smooth_image(1), case)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).astype(int)
    got = port.decode_jpeg_device(data, device="cpu").numpy().astype(int)
    err = np.abs(got - want)
    assert err.mean() < 1.0, err.mean()
    assert err.max() <= (2 if case == "gray" else 6), err.max()
    lsb_check(got, ref.decode_jpeg_device(data))


def test_decode_jpeg_device_declines_what_the_reference_declines():
    assert port.decode_jpeg_device(b"not a jpeg", device="cpu") is None
    # 4:1:1 (luma 4x1 over chroma 1x1): a sampling the lanes do not serve
    data = bytearray(encode(smooth_image(6, 32, 64), "444"))
    sof = data.index(b"\xff\xc0")
    data[sof + 11] = 0x41
    assert ref.decode_jpeg_device(bytes(data)) is None
    assert port.decode_jpeg_device(bytes(data), device="cpu") is None


def test_default_device_is_the_gpu():
    co = imgcodec.jpeg_coefficients(encode(smooth_image(7, 16, 16), "gray"))
    c = co.components[0]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.decode_grayscale_from_coefficients(c["coeffs"], c["quant"], 16, 16)
