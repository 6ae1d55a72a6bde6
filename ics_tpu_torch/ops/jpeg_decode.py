"""Device-side JPEG decode back end (counterpart of ``ics_tpu/ops/jpeg_decode.py``).

The host performs only the serial Huffman entropy decode
(``ics_tpu_torch.native.imgcodec.jpeg_coefficients``); everything after
runs on the device as plain tensor operations:

  dequant (elementwise) -> 8x8 iDCT as two matmuls per block
  -> block reassembly -> fancy (triangular) chroma upsampling
  -> YCbCr -> RGB

For a block F, f = Bᵀ F B with the orthonormal DCT-II basis B; over every
block of a batch it is one [blocks, 64] x [64, 64] matmul against B ⊗ B. The functions run in fp32
and take any number of leading batch dimensions (``[..., bh, bw, 64]``
coefficients, ``[..., 64]`` quant tables). On the GPU the engine turns TF32
off (``disable_tf32``), so the matmuls are the fp32 function the JAX package
computes on the CPU.

Supports baseline/progressive JPEGs with 4:4:4, 4:2:2 and 4:2:0 sampling
and grayscale.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ics_tpu_torch import get_device


@functools.lru_cache()
def _dct_basis() -> np.ndarray:
    """B[u, x] = alpha(u) cos((2x+1) u pi / 16), shape [8, 8]."""
    B = np.zeros((8, 8), np.float32)
    for u in range(8):
        alpha = math.sqrt(0.125) if u == 0 else math.sqrt(0.25)
        for x in range(8):
            B[u, x] = alpha * math.cos((2 * x + 1) * u * math.pi / 16.0)
    return B


def widen_quant(quant: torch.Tensor) -> torch.Tensor:
    """uint16 quant tables -> fp32. They may arrive as their int16 bit
    pattern (how ``uint16`` numpy arrays cross to the device), which is
    read back as unsigned."""
    if quant.dtype == torch.int16:
        return (quant.to(torch.int32) & 0xFFFF).float()
    return quant.float()


_IDCT_MATRICES: dict = {}


def _idct_matrix(device) -> torch.Tensor:
    """K[(u, v), (x, y)] = B[u, x] B[v, y], [64, 64] fp32 on ``device``, made
    once per device: a block's iDCT f = Bᵀ F B is its 64 coefficients times K."""
    key = str(device)
    k = _IDCT_MATRICES.get(key)
    if k is None:
        B = torch.from_numpy(_dct_basis())
        k = torch.einsum("ux,vy->uvxy", B, B).reshape(64, 64).to(device)
        _IDCT_MATRICES[key] = k
    return k


def idct_plane(coeffs: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """coeffs [..., bh, bw, 64] (natural order) + quant [..., 64]
    -> pixel plane [..., bh*8, bw*8] float32 (level-shifted, unclipped).

    f = Bᵀ F B for every block at once, as one [blocks, 64] x [64, 64]
    matmul against the Kronecker product of the basis with itself."""
    *lead, bh, bw, _ = coeffs.shape
    F = coeffs.float() * widen_quant(quant)[..., None, None, :]
    f = torch.matmul(F, _idct_matrix(coeffs.device)).reshape(*lead, bh, bw, 8, 8)
    n = len(lead)
    plane = f.permute(*range(n), n, n + 2, n + 1, n + 3).reshape(*lead, bh * 8, bw * 8)
    return plane + 128.0


def _fancy_upsample_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """libjpeg 'fancy' (triangular) 2x upsampling along one axis:
    out[2i] = (3*x[i] + x[i-1]) / 4, out[2i+1] = (3*x[i] + x[i+1]) / 4,
    edges clamped."""
    axis %= x.ndim
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    even = (3.0 * x + prev) * 0.25
    odd = (3.0 * x + nxt) * 0.25
    out = torch.stack([even, odd], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample_chroma(plane: torch.Tensor, h_factor: int, v_factor: int) -> torch.Tensor:
    """Upsample [..., H, W] by 2x per requested axis using the triangular
    filter (matches libjpeg/PIL 'fancy' upsampling within rounding)."""
    out = plane
    if v_factor == 2:
        out = _fancy_upsample_axis(out, -2)
    if h_factor == 2:
        out = _fancy_upsample_axis(out, -1)
    return out


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 rounded: bool = True) -> torch.Tensor:
    """[..., H, W] planes -> [..., H, W, 3]; rounded half-to-even and
    clipped to [0, 255] unless ``rounded`` is False."""
    cb = cb - 128.0
    cr = cr - 128.0
    r = torch.add(y, cr, alpha=1.402)
    g = torch.add(y, cb, alpha=-0.344136).add_(cr, alpha=-0.714136)
    b = torch.add(y, cb, alpha=1.772)
    rgb = torch.stack([r, g, b], dim=-1)
    return rgb.round_().clamp_(0.0, 255.0) if rounded else rgb


def as_device_tensor(x, device, non_blocking: bool = False) -> torch.Tensor:
    """A numpy array or tensor on ``device``, dtype kept; uint16 arrays cross
    as their int16 bit pattern (``widen_quant`` reads them back). A tensor in
    page-locked memory may cross ``non_blocking``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=non_blocking)
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint16:
        x = x.view(np.int16)
    return torch.from_numpy(x).to(device)


@torch.inference_mode()
def decode_from_coefficients(
    y_coeffs, y_quant, cb_coeffs, cb_quant, cr_coeffs, cr_quant,
    width: int, height: int, samp: tuple = (2, 2), out_dtype=torch.uint8,
    device=None,
) -> torch.Tensor:
    """Device-side JPEG back end for one YCbCr image.

    ``samp`` is the luma (h_samp, v_samp) relative to chroma: (1,1)=4:4:4,
    (2,1)=4:2:2, (2,2)=4:2:0. Coefficient arrays are [bh, bw, 64].
    Returns RGB [height, width, 3] in ``out_dtype`` on ``device`` (the GPU
    unless the caller names another).
    """
    device = get_device(device)
    y = idct_plane(as_device_tensor(y_coeffs, device), as_device_tensor(y_quant, device))
    cb = idct_plane(as_device_tensor(cb_coeffs, device), as_device_tensor(cb_quant, device))
    cr = idct_plane(as_device_tensor(cr_coeffs, device), as_device_tensor(cr_quant, device))
    cb = upsample_chroma(cb, samp[0], samp[1])
    cr = upsample_chroma(cr, samp[0], samp[1])
    # all planes now on the (padded) luma grid; crop to true size
    y, cb, cr = y[:height, :width], cb[:height, :width], cr[:height, :width]
    return ycbcr_to_rgb(y, cb, cr).to(out_dtype)


@torch.inference_mode()
def decode_grayscale_from_coefficients(y_coeffs, y_quant, width: int, height: int,
                                       out_dtype=torch.uint8, device=None) -> torch.Tensor:
    device = get_device(device)
    y = idct_plane(as_device_tensor(y_coeffs, device),
                   as_device_tensor(y_quant, device))[:height, :width]
    y = torch.clamp(torch.round(y), 0.0, 255.0)
    return y[..., None].expand(height, width, 3).to(out_dtype)


def decode_jpeg_device(data: bytes, out_dtype=torch.uint8, device=None) -> Optional[torch.Tensor]:
    """bytes -> RGB on ``device``, or None when unsupported (caller falls
    back to full host decode)."""
    from ics_tpu_torch.native import imgcodec

    co = imgcodec.jpeg_coefficients(data)
    if co is None or co.width < 1 or co.height < 1:
        return None
    if len(co.components) == 1:
        c = co.components[0]
        return decode_grayscale_from_coefficients(
            c["coeffs"], c["quant"], co.width, co.height, out_dtype, device)
    if len(co.components) != 3:
        return None
    yc, cbc, crc = co.components
    # divisibility FIRST: sampling factors run 1-4, so 3/2 would floor-divide
    # to 1 and pass for 4:4:4 with undersized chroma planes
    if (yc["h_samp"] % cbc["h_samp"]) or (yc["v_samp"] % cbc["v_samp"]):
        return None
    h_ratio = yc["h_samp"] // cbc["h_samp"]
    v_ratio = yc["v_samp"] // cbc["v_samp"]
    if (h_ratio, v_ratio) not in ((1, 1), (2, 1), (2, 2)):
        return None
    if cbc["h_samp"] != crc["h_samp"] or cbc["v_samp"] != crc["v_samp"]:
        return None
    return decode_from_coefficients(
        yc["coeffs"], yc["quant"], cbc["coeffs"], cbc["quant"],
        crc["coeffs"], crc["quant"],
        width=co.width, height=co.height, samp=(h_ratio, v_ratio),
        out_dtype=out_dtype, device=device,
    )
