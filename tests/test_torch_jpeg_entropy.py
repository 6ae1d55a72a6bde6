"""The port's own JPEG entropy decoder (``ics_tpu_torch/native/jpeg_entropy.cpp``)
against libjpeg's ``jpeg_read_coefficients`` as the JAX package's shim gives it
(``ics_tpu.native.imgcodec.jpeg_coefficients``): the same coefficients, quant
tables, sampling factors, block counts, width and height, bit for bit, on
PIL-encoded files of every sampling, coding process and restart layout, and
on the same files cut short. Then what it declines, and seeded byte
mutations that must not crash the process.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFilter

from ics_tpu.native import imgcodec as ref
from ics_tpu_torch.native import imgcodec as port

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not ref.available(), reason="native imgcodec not built")

MODES = {"444": 0, "422": 1, "420": 2, "gray": None}


def encode(h, w, mode="420", seed=0, quality=90, **kw) -> bytes:
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
    img = img.filter(ImageFilter.GaussianBlur(1))
    buf = io.BytesIO()
    if mode == "gray":
        img.convert("L").save(buf, "JPEG", quality=quality, **kw)
    else:
        img.save(buf, "JPEG", quality=quality, subsampling=MODES[mode], **kw)
    return buf.getvalue()


def assert_same(data: bytes):
    """The port's result equals the reference's, field by field; returns it."""
    want, got = ref.jpeg_coefficients(data), port.jpeg_coefficients(data)
    assert (got is None) == (want is None)
    if want is None:
        return None
    assert (got.width, got.height) == (want.width, want.height)
    assert len(got.components) == len(want.components)
    for g, w in zip(got.components, want.components):
        assert (g["h_samp"], g["v_samp"]) == (w["h_samp"], w["v_samp"])
        assert g["coeffs"].shape == w["coeffs"].shape          # block counts
        assert g["coeffs"].dtype == np.int16 and g["quant"].dtype == np.uint16
        np.testing.assert_array_equal(g["quant"], w["quant"])
        np.testing.assert_array_equal(g["coeffs"], w["coeffs"])
    return got


def segments(data: bytes):
    """(marker, offset, total length) of each segment before the first SOS,
    then the SOS itself."""
    i = 2
    while i + 4 <= len(data):
        marker, length = data[i + 1], (data[i + 2] << 8) | data[i + 3]
        yield marker, i, 2 + length
        if marker == 0xDA:
            return
        i += 2 + length


def rewrite(data: bytes, marker: int, offset_in_segment: int, value: int) -> bytes:
    """``data`` with one byte of the first segment of ``marker`` replaced
    (``offset_in_segment`` counts from the segment's FF)."""
    for m, i, _ in segments(data):
        if m == marker:
            out = bytearray(data)
            out[i + offset_in_segment] = value
            return bytes(out)
    raise AssertionError(f"no marker {marker:#x}")


VARIANTS = {
    "baseline": {},
    "progressive": {"progressive": True},
    "optimize": {"optimize": True},
}


@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_equals_libjpeg_by_mode_coding_and_quality(mode, variant, quality):
    got = assert_same(encode(100, 130, mode, seed=quality, quality=quality, **VARIANTS[variant]))
    assert got is not None and (got.height, got.width) == (100, 130)
    assert len(got.components) == (1 if mode == "gray" else 3)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (8, 8), (17, 33), (100, 130), (600, 520)])
def test_equals_libjpeg_by_size(size, mode, progressive):
    h, w = size
    got = assert_same(encode(h, w, mode, seed=h * w, progressive=progressive))
    assert got is not None and (got.height, got.width) == (h, w)


def test_planes_are_not_padded_to_whole_mcus():
    """ceil(dim * samp / (maxsamp * 8)) blocks per axis, as libjpeg gives."""
    for mode, chroma in (("420", (7, 9)), ("422", (13, 9)), ("444", (13, 17))):
        co = assert_same(encode(100, 130, mode))
        assert co.components[0]["coeffs"].shape[:2] == (13, 17)
        assert co.components[1]["coeffs"].shape[:2] == chroma, mode


RESTARTS = {"blocks1": {"restart_marker_blocks": 1}, "blocks4": {"restart_marker_blocks": 4},
            "rows1": {"restart_marker_rows": 1}}


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("restart", sorted(RESTARTS))
def test_equals_libjpeg_with_restart_intervals(restart, mode, progressive):
    data = encode(60, 90, mode, seed=3, progressive=progressive, **RESTARTS[restart])
    assert any(m == 0xDD for m, _, _ in segments(data))        # DRI present
    assert b"\xff\xd0" in data                                # RST markers present
    assert assert_same(data) is not None


TRUNCATED = {
    "baseline420": dict(mode="420"),
    "progressive420": dict(mode="420", progressive=True),
    "restart420": dict(mode="420", restart_marker_blocks=2),
    "progressive_gray": dict(mode="gray", progressive=True),
}


@pytest.mark.parametrize("fraction", [0.3, 0.5, 0.75, 0.9, 0.98])
@pytest.mark.parametrize("case", sorted(TRUNCATED))
def test_truncated_streams_decode_as_libjpeg_does(case, fraction):
    """A cut stream still succeeds: the MCU in progress decodes on zero bits
    and the rest of its restart segment stays zero."""
    data = encode(100, 130, seed=5, **TRUNCATED[case])
    cut = data[: int(len(data) * fraction)]
    got = assert_same(cut)
    if fraction >= 0.5 and not TRUNCATED[case].get("progressive"):
        assert got is not None
        luma = got.components[0]["coeffs"]
        assert 0 < np.count_nonzero(luma[..., 0]) < luma[..., 0].size


def test_every_cut_of_a_small_progressive_file_agrees():
    """Cuts every 5 bytes, through marker segments between scans too."""
    data = encode(24, 40, "420", seed=9, progressive=True)
    for end in range(0, len(data), 5):
        assert_same(data[:end])


def sixteen_bit_dqt(data: bytes, scale: int) -> bytes:
    """``data`` with every DQT table rewritten as 16-bit entries, each the
    original times ``scale`` (PIL writes 8-bit tables only)."""
    out, last = [], 0
    for marker, offset, length in segments(data):
        if marker != 0xDB:
            continue
        body, tables = data[offset + 4:offset + length], b""
        while body:
            index, values = body[0] & 15, body[1:65]
            tables += bytes([0x10 | index]) + b"".join(
                (v * scale).to_bytes(2, "big") for v in values)
            body = body[65:]
        out += [data[last:offset], b"\xff\xdb", (len(tables) + 2).to_bytes(2, "big"), tables]
        last = offset + length
    return b"".join(out) + data[last:]


def test_sixteen_bit_quant_tables():
    data = encode(40, 48, "420")
    wide = sixteen_bit_dqt(data, 20)
    assert any(m == 0xDB and wide[i + 4] >> 4 == 1 for m, i, _ in segments(wide))
    got = assert_same(wide)
    base = port.jpeg_coefficients(data)
    for g, b in zip(got.components, base.components):
        np.testing.assert_array_equal(g["quant"], b["quant"] * 20)
        assert int(g["quant"].max()) > 255
        np.testing.assert_array_equal(g["coeffs"], b["coeffs"])


def test_stream_without_dht_takes_the_standard_tables():
    """Motion-JPEG frames carry no DHT; libjpeg fills slots 0 and 1 with the
    T.81 Annex K tables, which a non-optimized PIL file also uses."""
    data = encode(40, 48, "420")
    parts, i = [data[:2]], 2
    for marker, offset, length in segments(data):
        if marker != 0xC4:
            parts.append(data[offset:offset + length])
        i = offset + length
    stripped = b"".join(parts) + data[i:]
    assert b"\xff\xc4" not in stripped[: stripped.index(b"\xff\xda")]
    got = assert_same(stripped)
    np.testing.assert_array_equal(got.components[0]["coeffs"],
                                  port.jpeg_coefficients(data).components[0]["coeffs"])


def test_threads_give_the_same_bits():
    data = encode(60, 90, "420", restart_marker_blocks=2)
    one, four = port.jpeg_coefficients(data, 1), port.jpeg_coefficients(data, 4)
    for a, b in zip(one.components, four.components):
        np.testing.assert_array_equal(a["coeffs"], b["coeffs"])


@pytest.mark.parametrize("case", ["garbage", "empty", "png", "sof9", "sof3", "precision12",
                                  "past_pixel_cap", "no_scan"])
def test_declined_files_give_none(case):
    data = encode(40, 48, "420")
    png = io.BytesIO()
    Image.new("RGB", (8, 8)).save(png, "PNG")
    sof = next(i for m, i, _ in segments(data) if m == 0xC0)
    blobs = {
        "garbage": b"\xff\xd8\xff" + os.urandom(64),
        "empty": b"",
        "png": png.getvalue(),
        "sof9": rewrite(data, 0xC0, 1, 0xC9),        # arithmetic coding
        "sof3": rewrite(data, 0xC0, 1, 0xC3),        # lossless
        "precision12": rewrite(data, 0xC0, 4, 12),
        # 65000 x 65000 declared, over ICSTPU_MAX_PIXELS
        "past_pixel_cap": data[:sof + 5] + b"\xfd\xe8\xfd\xe8" + data[sof + 9:],
        "no_scan": data[:data.index(b"\xff\xda")] + b"\xff\xd9",
    }
    assert port.jpeg_coefficients(blobs[case]) is None
    if case not in ("sof9", "garbage"):                 # libjpeg decodes arithmetic coding
        assert ref.jpeg_coefficients(blobs[case]) is None


def test_probe_needs_no_library():
    assert port.probe(encode(8, 8)) == "jpeg"
    png = io.BytesIO()
    Image.new("RGB", (8, 8)).save(png, "PNG")
    assert port.probe(png.getvalue()) == "png"
    assert port.probe(b"GIF89a") is None and port.probe(b"\xff\xd8") is None


_FUZZ = r"""
import io, json, sys
import numpy as np
from PIL import Image, ImageFilter
from ics_tpu_torch.native import imgcodec

rng = np.random.default_rng(int(sys.argv[1]))
seen = {"none": 0, "decoded": 0}
for kw in ({}, {"progressive": True}, {"restart_marker_blocks": 2}, {"optimize": True}):
    img = Image.fromarray(rng.integers(0, 256, (40, 56, 3), np.uint8))
    img = img.filter(ImageFilter.GaussianBlur(1))
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=85, **kw)
    data = buf.getvalue()
    for _ in range(400):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            pos = int(rng.integers(0, len(b)))
            flip = b[pos] ^ (1 << int(rng.integers(0, 8)))
            b[pos] = int(rng.integers(0, 256)) if rng.random() < 0.7 else flip
        if rng.random() < 0.3:
            b = b[: int(rng.integers(2, len(b)))]
        co = imgcodec.jpeg_coefficients(bytes(b))
        if co is None:
            seen["none"] += 1
            continue
        seen["decoded"] += 1
        assert co.width >= 1 and co.height >= 1 and 1 <= len(co.components) <= 4
        for c in co.components:
            assert c["coeffs"].ndim == 3 and c["coeffs"].shape[2] == 64
print(json.dumps(seen))
"""


@pytest.mark.parametrize("seed", [0, 1])
def test_mutated_files_never_crash_the_process(seed):
    """Seeded byte mutations and cuts of four kinds of file, decoded in a
    child process so that a crash shows as its exit status."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", _FUZZ, str(seed)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["none"] + seen["decoded"] == 1600 and seen["decoded"] > 0
