"""Native host shims via ctypes.

``ics_tpu_torch.native.imgcodec`` exposes:
- ``decode(data) -> np.ndarray | None``  (RGB uint8 [H, W, 3]; libjpeg/libpng)
- ``sha256_hex(data) -> str``
- ``probe(data) -> "jpeg" | "png" | None``  (Python, needs no library)
- ``jpeg_coefficients(data) -> JpegCoefficients | None``  (the port's own
  entropy decoder, ``jpeg_entropy.cpp``, no libjpeg)

The libjpeg/libpng shim is built on first use (``make`` in this directory)
and its callers degrade to PIL/hashlib where it cannot be; the entropy
decoder is built by ``g++`` into ``build/ics_tpu_torch/`` on first use, and
a failed build raises with the compiler's output.
"""
