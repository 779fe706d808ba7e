"""The port's standard-library PNG decoder (``png_io.decode_png``,
``png_io.load_image``) against PIL, bit for bit.

The reference value is the JAX package's own decode,
``np.asarray(Image.open(...).convert("RGB"), np.float32) / 255.0``.  The
PNGs are built here with every row filtered by one chosen filter type
(None, Sub, Up, Average, Paeth, or all five in turn), for every colour
type the decoder takes, at odd widths, with the image data split over
several IDAT chunks; PIL's own files (its adaptive filters); and the
armor fixture's textures as tools/gen_fixtures.py and
rt_tpu_torch.fixtures write them.

Serial CPU time of this file: about 3 s.
"""

import base64
import io
import json
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from rt_tpu_torch import fixtures
from rt_tpu_torch.io import png_io

# PNG colour type -> (PIL mode of the decoded file, samples a pixel).
COLOR_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2), 6: ("RGBA", 4)}
FILTERS = (0, 1, 2, 3, 4, "mixed")


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind: int, row: bytes, prev: bytes, bpp: int) -> bytes:
    """One scanline filtered as the PNG spec's encoder filters it."""
    out = bytearray()
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
        out.append((x - pred) & 0xFF)
    return bytes(out)


def make_png(pixels: np.ndarray, color_type: int, filters, palette=None, idat_parts: int = 3):
    """PNG bytes of u8[h, w, n] ``pixels``, row y filtered by
    ``filters[y % len(filters)]``, the zlib stream split into
    ``idat_parts`` IDAT chunks."""
    h, w, n = pixels.shape
    raw, prev = bytearray(), bytes(w * n)
    for y in range(h):
        row = pixels[y].tobytes()
        kind = filters[y % len(filters)]
        raw += bytes([kind]) + _filter_row(kind, row, prev, n)
        prev = row
    data = zlib.compress(bytes(raw), 9)
    cuts = np.linspace(0, len(data), idat_parts + 1).astype(int)
    out = png_io.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                                              0, 0, 0))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        out += _chunk(b"IDAT", data[lo:hi])
    return out + _chunk(b"IEND", b"")


def pil_rgb(data: bytes) -> np.ndarray:
    """The JAX package's decode of an image file."""
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32) / 255.0


def _assert_equal_to_pil(data: bytes):
    ref = pil_rgb(data)
    got = png_io.load_image(data)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(png_io.decode_png(data), np.asarray(
        Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("color_type", list(COLOR_TYPES))
def test_decoder_equals_pil(color_type, filt):
    rs = np.random.default_rng(color_type * 10 + (5 if filt == "mixed" else filt))
    _, n = COLOR_TYPES[color_type]
    h, w = 7, 13  # odd width: rows end mid-word for every sample count
    # Smooth ramps plus noise, so that every predictor gives other bytes.
    ramp = (np.arange(w)[None, :, None] * 17 + np.arange(h)[:, None, None] * 29) % 256
    pixels = ((ramp + rs.integers(0, 40, (h, w, n))) % 256).astype(np.uint8)
    palette = None
    if color_type == 3:
        palette = rs.integers(0, 256, (64, 3), dtype=np.uint8)
        pixels = (pixels % 64).astype(np.uint8)
    filters = (0, 1, 2, 3, 4) if filt == "mixed" else (filt,)
    data = make_png(pixels, color_type, filters, palette)
    assert Image.open(io.BytesIO(data)).mode == COLOR_TYPES[color_type][0]
    _assert_equal_to_pil(data)


@pytest.mark.parametrize("mode", ["L", "RGB", "LA", "RGBA", "P"])
def test_decoder_equals_pil_on_pil_files(mode):
    """Files PIL writes, with its own filter choice per row."""
    rs = np.random.default_rng(7)
    n = {"L": 1, "RGB": 3, "LA": 2, "RGBA": 4, "P": 1}[mode]
    arr = rs.integers(0, 256, (33, 31, n), dtype=np.uint8)
    arr = arr + (np.arange(31, dtype=np.uint8)[None, :, None] * 3)
    img = Image.fromarray(arr[..., 0] if n == 1 else arr, mode)
    if mode == "P":
        img.putpalette(list(rs.integers(0, 256, 768)))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    _assert_equal_to_pil(buf.getvalue())


def _glb_images(path):
    """The PNG bytes of a glb's data-URI images."""
    with open(path, "rb") as f:
        blob = f.read()
    length, _ = struct.unpack("<II", blob[12:20])
    doc = json.loads(blob[20 : 20 + length])
    return [base64.b64decode(im["uri"].split(",", 1)[1]) for im in doc["images"]]


@pytest.mark.parametrize("writer", ["tools", "port"])
def test_armor_fixture_images_equal_pil(writer, tmp_path):
    """The armor fixture's textures, as tools/gen_fixtures.py (PIL) and
    rt_tpu_torch.fixtures (encode_png) write them, decode as PIL decodes
    them.  (Their texels are equal across the writers:
    tests/test_torch_bench.py.)"""
    from tools import gen_fixtures

    path = str(tmp_path / "armor.glb")
    (gen_fixtures if writer == "tools" else fixtures).make_glb_armor(path, res=8, n_parts=3)
    images = _glb_images(path)
    assert len(images) == 3
    for data in images:
        _assert_equal_to_pil(data)


def test_load_image_png_needs_no_pil(monkeypatch, tmp_path):
    """With PIL unimportable, PNG bytes and files still decode; any other
    file raises and says why."""
    pixels = np.random.default_rng(3).integers(0, 256, (5, 9, 3), dtype=np.uint8)
    data = png_io.encode_png(pixels)
    ref = pil_rgb(data)
    path = tmp_path / "t.png"
    path.write_bytes(data)
    sixteen = bytearray(make_png(pixels, 2, (0,)))
    sixteen[24] = 16  # IHDR bit depth: a valid PNG the decoder leaves to PIL
    sixteen[29:33] = struct.pack(">I", zlib.crc32(bytes(sixteen[12:29])) & 0xFFFFFFFF)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(png_io.load_image(data), ref)
    np.testing.assert_array_equal(png_io.load_image(str(path)), ref)
    np.testing.assert_array_equal(png_io.decode_png(data), pixels)
    for other in (b"\xff\xd8\xff\xe0 a JPEG header", bytes(sixteen)):
        with pytest.raises(RuntimeError, match="needs PIL"):
            png_io.load_image(other)


def test_damaged_png_raises():
    data = bytearray(png_io.encode_png(np.zeros((2, 3, 3), np.uint8)))
    data[-20] ^= 0xFF  # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        png_io.decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png_io.decode_png(b"GIF89a")
