from __future__ import annotations

import ctypes
import logging
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_HERE = Path(__file__).parent
_SO = _HERE / "libimgcodec.so"

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-s", "libimgcodec.so"], cwd=_HERE, check=True,
            capture_output=True, timeout=120,
        )
        return _SO.exists()
    except Exception as exc:
        logger.warning("native imgcodec build failed: %s", exc)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    # ALWAYS invoke make (timestamp no-op when fresh): an existence-only
    # check kept loading a stale .so after source updates, and a missing
    # NEW symbol then raised past the fallback (self-review r3)
    if not _build() and not _SO.exists():
        _build_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
        lib.icstpu_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.icstpu_decode.restype = ctypes.c_int
        lib.icstpu_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        lib.icstpu_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.icstpu_probe.restype = ctypes.c_int
        lib.icstpu_sha256.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p
        ]
        lib.icstpu_jpeg_coeffs.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.icstpu_jpeg_coeffs.restype = ctypes.c_int
        lib.icstpu_jpeg_coeffs_mt.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
        ]
        lib.icstpu_jpeg_coeffs_mt.restype = ctypes.c_int
        _lib = lib
        return lib
    except (OSError, AttributeError) as exc:
        # AttributeError = stale .so missing a new symbol: degrade to the
        # PIL/serial fallbacks instead of 500ing every decode
        logger.warning("native imgcodec unavailable: %s", exc)
        _build_failed = True
        return None


def available() -> bool:
    return _load() is not None


def probe(data: bytes) -> Optional[str]:
    lib = _load()
    if lib is None:
        return None
    kind = lib.icstpu_probe(data, len(data))
    return {1: "jpeg", 2: "png"}.get(kind)


def decode(data: bytes) -> Optional[np.ndarray]:
    """bytes -> RGB uint8 [H, W, 3]; None when format unsupported or the
    native library is unavailable (caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_ubyte)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.icstpu_decode(data, len(data), ctypes.byref(out),
                           ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    try:
        n = h.value * w.value * 3
        arr = np.ctypeslib.as_array(out, shape=(n,)).reshape(h.value, w.value, 3)
        return arr.copy()
    finally:
        lib.icstpu_free(out)


class JpegCoefficients:
    """Entropy-decoded JPEG: quantized DCT coefficient planes + quant tables.

    ``components`` is a list of dicts with int16 ``coeffs``
    [blocks_h, blocks_w, 64] (natural order), ``quant`` uint16 [64],
    ``h_samp``/``v_samp``; plus image ``width``/``height``.
    """

    def __init__(self, width, height, components):
        self.width = width
        self.height = height
        self.components = components


def _parse_coeff_buffer(lib, out, out_len) -> JpegCoefficients:
    try:
        raw = np.ctypeslib.as_array(out, shape=(out_len.value,))
        # header layout mirrors CoeffHeader in imgcodec.cpp
        ints = raw[: 4 * (3 + 16)].view(np.int32)
        num_comp = int(ints[0])
        width, height = int(ints[1]), int(ints[2])
        comp_meta = ints[3:3 + 16].reshape(4, 4)
        quant = raw[4 * 19: 4 * 19 + 4 * 64 * 2].view(np.uint16).reshape(4, 64)
        cursor = 4 * 19 + 4 * 64 * 2
        components = []
        for c in range(num_comp):
            bw, bh, hs, vs = (int(x) for x in comp_meta[c])
            n = bh * bw * 64 * 2
            coeffs = (
                raw[cursor:cursor + n].view(np.int16).reshape(bh, bw, 64).copy()
            )
            cursor += n
            components.append(
                {
                    "coeffs": coeffs,
                    "quant": quant[c].copy(),
                    "h_samp": hs,
                    "v_samp": vs,
                }
            )
        return JpegCoefficients(width, height, components)
    finally:
        lib.icstpu_free(out)


# Below this file size the parallel path isn't worth starting: thread
# spawn + one libjpeg header re-parse per chunk cost ~0.5 ms total, which
# a sub-100KB scan decodes in anyway. Content-INDEPENDENT by design — the
# per-chunk decoder is libjpeg itself (jpeg_mt.cpp), so summed CPU tracks
# the serial path on any content class; only the fixed overhead needs
# amortizing. Tests set this to 0 to exercise the MT path on small files.
MT_MIN_BYTES = 96 * 1024


def jpeg_coefficients(
    data: bytes, threads: int = 1
) -> Optional[JpegCoefficients]:
    """Host Huffman decode only; everything after runs on the device.

    ``threads > 1`` takes the restart-marker parallel path (jpeg_mt.cpp:
    contiguous restart segments wrapped into synthesized single-MCU-row
    JPEGs, each decoded by libjpeg on a worker thread) when the file is
    eligible (baseline Huffman, DRI > 0, >=2 segments) and big enough to
    amortize the fixed overhead (``MT_MIN_BYTES``); anything else falls
    back to the serial libjpeg decoder transparently.
    """
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_ubyte)()
    out_len = ctypes.c_size_t()
    if threads > 1 and len(data) >= MT_MIN_BYTES:
        rc = lib.icstpu_jpeg_coeffs_mt(
            data, len(data), ctypes.byref(out), ctypes.byref(out_len), threads
        )
        if rc == 0:
            return _parse_coeff_buffer(lib, out, out_len)
        # rc==1: not eligible; rc<0: malformed for the strict parser —
        # either way the serial decoder is the arbiter
    rc = lib.icstpu_jpeg_coeffs(data, len(data), ctypes.byref(out),
                                ctypes.byref(out_len))
    if rc != 0:
        return None
    return _parse_coeff_buffer(lib, out, out_len)


def sha256_hex(data: bytes) -> Optional[str]:
    """Correctness CROSS-CHECK of the C SHA-256 — NOT the production
    hash. The system's content identity is core/security.py::sha256_hex
    (hashlib: OpenSSL-backed, SHA-NI — faster than this portable C).
    Kept because the parity test (tests/test_native.py) diffing two
    independent implementations is what guards the identity function;
    do not route production hashing here."""
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(65)
    lib.icstpu_sha256(data, len(data), buf)
    return buf.value.decode("ascii")
