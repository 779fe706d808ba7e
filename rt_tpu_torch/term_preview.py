"""In-terminal progressive preview (rt_tpu/term_preview.py; reference
analog: the winit/pixels live window, window.rs:29-217: on a headless GPU
host the terminal is the display).

Two encodings:

- ``ansi`` (default, works in any 24-bit-color terminal): each character
  cell shows two vertical pixels via the upper-half-block glyph with
  truecolor foreground/background.
- ``kitty`` (auto-selected when ``TERM`` contains "kitty"): the kitty
  graphics protocol with a base64 PNG payload, at full resolution.  The
  PNG is encoded by ``io.png_io.encode_png`` (the standard library), not
  PIL, so its bytes differ from the JAX package's; its pixels do not.

Unlike the reference's preview (which blits linear color and left gamma
as a TODO, window.rs:32), frames are gamma-corrected before display.
"""

from __future__ import annotations

import base64
import io
import os
import sys

import numpy as np

from rt_tpu_torch.io.png_io import encode_png


def _to_u8(image_linear: np.ndarray) -> np.ndarray:
    """Linear f32[H,W,3] -> gamma-corrected u8 (the reference's gamma
    1/2.2, vec3.rs:39-42)."""
    img = np.clip(np.asarray(image_linear, np.float32), 0.0, 1.0)
    return (img ** (1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)


def _box_downsample(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Integer-grid box average to (out_h, out_w); cheap and alias-free
    enough for a preview."""
    h, w = img.shape[:2]
    ys = (np.arange(out_h + 1) * h // out_h).clip(0, h)
    xs = (np.arange(out_w + 1) * w // out_w).clip(0, w)
    out = np.empty((out_h, out_w, 3), np.float32)
    for i in range(out_h):
        rows = img[ys[i] : max(ys[i + 1], ys[i] + 1)]
        for j in range(out_w):
            out[i, j] = rows[:, xs[j] : max(xs[j + 1], xs[j] + 1)].mean(axis=(0, 1))
    return out


def ansi_frame(image_linear: np.ndarray, max_cols: int = 100) -> str:
    """Render to a string of truecolor half-block rows (two image rows per
    terminal row)."""
    h, w = image_linear.shape[:2]
    cols = min(max_cols, w)
    rows = max(2, round(cols * h / max(w, 1)))
    rows += rows % 2  # half-blocks consume two image rows per line
    small = _to_u8(_box_downsample(np.asarray(image_linear, np.float32), cols, rows))
    lines = []
    for y in range(0, rows, 2):
        cells = []
        for x in range(cols):
            tr, tg, tb = small[y, x]
            br, bg, bb = small[y + 1, x]
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def kitty_frame(image_linear: np.ndarray) -> str:
    """A kitty graphics-protocol escape carrying the full-resolution frame
    as PNG (chunked per the 4096-byte payload limit)."""
    payload = base64.standard_b64encode(encode_png(_to_u8(image_linear)))
    out = io.StringIO()
    first = True
    while payload:
        chunk, payload = payload[:4096], payload[4096:]
        more = 1 if payload else 0
        ctrl = f"a=T,f=100,m={more}" if first else f"m={more}"
        out.write(f"\x1b_G{ctrl};{chunk.decode('ascii')}\x1b\\")
        first = False
    return out.getvalue()


class TerminalPreview:
    """Progressive in-place terminal preview.

    >>> tp = TerminalPreview()
    >>> tp.update(image, {"pass": 3, "mray_per_s": 12.0})
    >>> tp.close()
    """

    def __init__(self, mode: str = "auto", max_cols: int = 100, stream=None):
        if mode == "auto":
            mode = "kitty" if "kitty" in os.environ.get("TERM", "") else "ansi"
        self.mode = mode
        self.max_cols = max_cols
        self.stream = stream if stream is not None else sys.stdout
        self._lines = 0

    def update(self, image_linear: np.ndarray, status: dict | None = None):
        if self._lines:
            # Cursor up over the previous frame so the preview refreshes
            # in place (the reference's 30 FPS redraw analog).
            self.stream.write(f"\x1b[{self._lines}F\x1b[J")
        if self.mode == "kitty":
            body = kitty_frame(image_linear)
            body_lines = 1
        else:
            body = ansi_frame(image_linear, self.max_cols)
            body_lines = body.count("\n") + 1
        tail = ""
        if status:
            parts = [f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in status.items()]
            tail = "  ".join(parts)
        self.stream.write(body + "\n" + tail + "\n")
        self.stream.flush()
        self._lines = body_lines + 1

    def close(self):
        self._lines = 0
