from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_HERE = Path(__file__).parent
_SO = _HERE / "libimgcodec.so"

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

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
        lib.icstpu_sha256.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p
        ]
        _lib = lib
        return lib
    except (OSError, AttributeError) as exc:
        # AttributeError = stale .so missing a new symbol: degrade to the
        # PIL fallback instead of 500ing every decode
        logger.warning("native imgcodec unavailable: %s", exc)
        _build_failed = True
        return None


def available() -> bool:
    return _load() is not None


def probe(data: bytes) -> Optional[str]:
    """``"jpeg"`` (SOI followed by a marker), ``"png"`` (its signature) or
    None; needs no library."""
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == PNG_SIGNATURE:
        return "png"
    return None


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


def _parse_coeff_buffer(out, out_len) -> JpegCoefficients:
    raw = np.ctypeslib.as_array(out, shape=(out_len.value,))
    # header layout mirrors CoeffHeader in coeff_header.h
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
        coeffs = raw[cursor:cursor + n].view(np.int16).reshape(bh, bw, 64).copy()
        cursor += n
        components.append(
            {"coeffs": coeffs, "quant": quant[c].copy(), "h_samp": hs, "v_samp": vs}
        )
    return JpegCoefficients(width, height, components)


# -- the port's own entropy decoder (jpeg_entropy.cpp, no libjpeg) -----------
ENTROPY_SRC = _HERE / "jpeg_entropy.cpp"
ENTROPY_BUILD_DIR = _HERE.parents[1] / "build" / "ics_tpu_torch"
CXX_FLAGS = ("-std=c++17", "-O3", "-Wall", "-fPIC", "-shared")
BUILD_TIMEOUT_S = 300

_entropy_lock = threading.Lock()
_entropy: Optional[ctypes.CDLL] = None


def entropy_library_path() -> Path:
    """``build/ics_tpu_torch/libjpeg_entropy-<digest>.so``: the digest covers
    the sources and the flags, so an edited source is rebuilt."""
    digest = hashlib.sha256()
    for src in (ENTROPY_SRC, _HERE / "coeff_header.h"):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return ENTROPY_BUILD_DIR / f"libjpeg_entropy-{digest.hexdigest()[:16]}.so"


def build_entropy() -> str:
    """Compile the entropy decoder with the C++ compiler if it is not built
    yet; returns the compiler's output ("" when it was built already).
    Raises RuntimeError with that output when the build fails."""
    out = entropy_library_path()
    if out.exists():
        return ""
    ENTROPY_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-I", str(_HERE), "-o", str(tmp),
           str(ENTROPY_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"building {ENTROPY_SRC.name} failed: {exc}") from exc
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {ENTROPY_SRC.name} failed (exit {proc.returncode}):\n{output}")
    os.replace(tmp, out)  # atomic: a concurrent build of the same digest is harmless
    return output


def load_entropy() -> ctypes.CDLL:
    """The entropy decoder's library, built on first use. Raises
    RuntimeError with the compiler's output when it cannot be built."""
    global _entropy
    with _entropy_lock:
        if _entropy is None:
            build_entropy()
            lib = ctypes.CDLL(str(entropy_library_path()))
            lib.icstpu_jpeg_entropy.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.icstpu_jpeg_entropy.restype = ctypes.c_int
            lib.icstpu_entropy_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
            _entropy = lib
        return _entropy


def jpeg_coefficients(data: bytes, threads: int = 1) -> Optional[JpegCoefficients]:
    """Host Huffman decode only; everything after runs on the device.

    The port's own decoder (``jpeg_entropy.cpp``) gives what libjpeg's
    ``jpeg_read_coefficients`` gives; None for a file it declines (not a
    JPEG, damaged headers, lossless/hierarchical/arithmetic coding, 12-bit
    samples, past the pixel cap). ``threads`` is taken for the reference's
    signature and runs serially: the result is the same bits.
    """
    lib = load_entropy()
    out = ctypes.POINTER(ctypes.c_ubyte)()
    out_len = ctypes.c_size_t()
    rc = lib.icstpu_jpeg_entropy(data, len(data), ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        return None
    try:
        return _parse_coeff_buffer(out, out_len)
    finally:
        lib.icstpu_entropy_free(out)


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
