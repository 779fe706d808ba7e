"""PNG output and image decoding.

``write_png`` is a standard-library PNG encoder (zlib + struct): 8-bit RGB,
no filtering, so writing an image needs nothing beyond Python and numpy.
``decode_png`` is the matching standard-library decoder: 8-bit samples,
not interlaced, grey, RGB, palette, grey-alpha and RGBA, all five filter
types, any number of IDAT chunks.  ``load_image`` (replacing the
reference's `image` crate decode, camera.rs:62-81, texture.rs:89-92)
decodes such PNGs itself, equal to PIL's ``convert("RGB")`` bit for bit,
and hands every other file to PIL, which is imported only then.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from rt_tpu_torch import color as color_mod


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + kind
        + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def encode_png(rgb: np.ndarray) -> bytes:
    """PNG bytes of a u8[H, W, 3] image."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"need (h, w, 3) u8, got {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, no interlace
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Samples a pixel for each PNG colour type (grey, RGB, palette, grey-alpha,
# RGBA).
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class UnsupportedPNG(ValueError):
    """A valid PNG that ``decode_png`` does not decode (bit depth other
    than 8, or interlaced)."""


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """u8[h, w * bpp] from the filtered scanlines (PNG spec section 9)."""
    stride = w * bpp
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum over each sample position
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind == 3:  # Average
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        elif kind == 4:  # Paeth
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """u8[H, W, 3] RGB of an 8-bit, non-interlaced PNG: grey copied to the
    three channels, palette indices looked up, alpha dropped (PIL's
    ``convert("RGB")``).  Raises UnsupportedPNG for other bit depths and
    interlaced files, ValueError for a damaged file."""
    data = bytes(data)
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG has no IHDR or no IDAT")
    w, h, depth, color_type, _, _, interlace = header
    if color_type not in _CHANNELS:
        raise ValueError(f"PNG colour type {color_type} is not defined")
    if depth != 8 or interlace != 0:
        raise UnsupportedPNG(f"PNG bit depth {depth}, interlace {interlace}")
    n = _CHANNELS[color_type]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w, n).reshape(h, w, n)
    if color_type == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        if int(pix.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[pix[..., 0]]
    if color_type in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def write_png(path: str, image_linear, gamma: bool = True) -> None:
    """Write a linear f32[H,W,3] image as 8-bit PNG (gamma-corrected by
    default, like the reference's final outputs)."""
    img = torch.as_tensor(np.asarray(image_linear, np.float32))
    rgb = (color_mod.to_u8_gamma(img) if gamma else color_mod.to_u8(img)).numpy()
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def load_image(path_or_bytes) -> np.ndarray:
    """Decode an image file (PNG/JPEG/WebP/...) to f32[H,W,3] in [0,1],
    channels scaled by 1/255 with no gamma handling (camera.rs:62-81).
    8-bit non-interlaced PNGs decode with ``decode_png``; other files need
    PIL."""
    import io as _io

    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:8] == PNG_SIGNATURE:
        try:
            return np.asarray(decode_png(data), np.float32) / 255.0
        except UnsupportedPNG:
            pass
    try:
        from PIL import Image
    except ImportError as err:
        raise RuntimeError(
            "decoding this image needs PIL, which is not installed: only 8-bit, "
            "non-interlaced PNGs decode without it") from err
    return np.asarray(Image.open(_io.BytesIO(data)).convert("RGB"), np.float32) / 255.0
