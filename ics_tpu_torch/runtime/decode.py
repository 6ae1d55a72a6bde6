"""Host-side image decode + canvas staging.

Decode happens on the host CPU (JPEG Huffman parsing is irreducibly serial);
everything after the uint8 pixels — resize/crop/normalize/forward — runs on
the GPU. A C++ libjpeg/libpng shim (``ics_tpu_torch.native``) is used when built;
PIL is the fallback. Output canvases are C-contiguous uint8 NHWC, staged for
a single ``device_put``.
"""

from __future__ import annotations

import io
from typing import Optional, Sequence

import numpy as np

try:
    from ics_tpu_torch.native import imgcodec as _native
except Exception:  # pragma: no cover - built lazily
    _native = None

from PIL import Image

DEFAULT_CANVAS = 512


class ImagemInvalida(ValueError):
    """Deterministic CLIENT input failure (undecodable bytes).

    Subclasses ValueError so existing ``except (OSError, ValueError)``
    route handlers keep working, but gives the hedging layer a PRECISE
    exemption type: a bare ValueError from a wedged replica's runtime
    (JAX device/sharding errors are ValueErrors) must still hedge
    (self-review r3)."""


def decode_image(data: bytes) -> np.ndarray:
    """bytes -> RGB uint8 [H, W, 3]. Raises :class:`ImagemInvalida` on
    undecodable input."""
    if _native is not None:
        out = _native.decode(data)
        if out is not None:
            return out
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception as exc:
        raise ImagemInvalida(f"imagem não decodificável: {exc}") from exc


def image_metadata(data: bytes) -> dict:
    """Width/height/format/mode — parity with the reference's PIL metadata
    extraction (``webdav_sync.py:83-103``)."""
    with Image.open(io.BytesIO(data)) as im:
        return {
            "width": im.width,
            "height": im.height,
            "format": im.format,
            "mode": im.mode,
        }


def pick_canvas(h: int, w: int, buckets: Sequence[int] = (256, 512, 1024, 2048)) -> int:
    side = max(h, w)
    for b in buckets:
        if side <= b:
            return b
    return buckets[-1]


def stage_batch(
    images: Sequence[np.ndarray], canvas: Optional[int] = None
) -> tuple[np.ndarray, np.ndarray]:
    """Stage decoded images into one uint8 canvas batch + true sizes.

    Oversized images are pre-shrunk on host by integer striding (cheap, and
    preserves >=2x the target resolution so device-side antialiased resize
    quality is unaffected).
    """
    if canvas is None:
        canvas = max(pick_canvas(im.shape[0], im.shape[1]) for im in images)
        canvas = min(canvas, DEFAULT_CANVAS * 2)
    batch = np.zeros((len(images), canvas, canvas, 3), np.uint8)
    sizes = np.zeros((len(images), 2), np.int32)
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        stride = max((max(h, w) + canvas - 1) // canvas, 1)
        if stride > 1:
            img = img[::stride, ::stride]
            h, w = img.shape[:2]
        batch[i, :h, :w] = img
        sizes[i] = (h, w)
    return batch, sizes
