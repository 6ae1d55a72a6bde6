"""Native host shims — C++ (libjpeg/libpng decode + SHA-256) via ctypes.

``ics_tpu_torch.native.imgcodec`` exposes:
- ``decode(data) -> np.ndarray | None``  (RGB uint8 [H, W, 3])
- ``probe(data) -> "jpeg" | "png" | None``
- ``sha256_hex(data) -> str``

The shared library is built on first import (``make`` in this directory);
every caller degrades gracefully to the PIL/hashlib fallbacks when the
toolchain or libs are unavailable.
"""
