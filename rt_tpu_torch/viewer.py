"""Live progressive preview over HTTP (rt_tpu/viewer.py).

Reference analog: the winit + pixels preview window (window.rs:33-217), a
30 FPS framebuffer fed by the render thread, with click-to-inspect.  A GPU
host has no desktop, so the progressive engine pushes each sweep's image
into this server, and any browser shows the latest frame (auto-refreshing)
with click-to-probe wired to the same debug probe as the reference's mouse
handler (window.rs:141-172 -> debug.py).  Gamma correction is applied for
display, fixing the reference's ungamma'd-preview TODO (window.rs:32,
196-202), while accumulation stays linear.  Frames are encoded by
``io.png_io.encode_png`` (the standard library; the GPU host has no PIL).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from rt_tpu_torch import color as color_mod
from rt_tpu_torch.io.png_io import encode_png

_PAGE = """<!doctype html>
<html><head><title>rt_tpu preview</title><style>
body { background: #111; color: #ddd; font-family: monospace; }
img { image-rendering: pixelated; max-width: 95vw; }
#info { white-space: pre; }
</style></head><body>
<div id="status">waiting for first sweep...</div>
<img id="frame" src="/frame.png">
<div id="info"></div>
<script>
const img = document.getElementById('frame');
setInterval(() => { img.src = '/frame.png?' + Date.now(); fetch('/status')
  .then(r => r.json()).then(s => {
    document.getElementById('status').textContent = JSON.stringify(s);
  }); }, 1000);
img.addEventListener('click', (e) => {
  const r = img.getBoundingClientRect();
  const x = Math.floor((e.clientX - r.left) / r.width * img.naturalWidth);
  const y = Math.floor((e.clientY - r.top) / r.height * img.naturalHeight);
  fetch(`/probe?x=${x}&y=${y}`).then(r => r.json()).then(d => {
    document.getElementById('info').textContent = JSON.stringify(d, null, 2);
  });
});
</script></body></html>"""


class PreviewServer:
    """Serves the latest progressive frame; optionally wires a probe
    callback (scene click-debug parity).  ``port`` 0 binds a free port
    (``self.port`` says which)."""

    def __init__(self, port: int = 8000, probe=None):
        self._png: bytes | None = None
        self._status: dict = {}
        self._probe = probe
        self._lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, content_type: str, body: bytes):
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with server._lock:
                        payload = server._png
                    if payload is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self._send("image/png", payload)
                elif self.path.startswith("/status"):
                    with server._lock:
                        body = json.dumps(server._status).encode()
                    self._send("application/json", body)
                elif self.path.startswith("/probe") and server._probe is not None:
                    q = parse_qs(urlparse(self.path).query)
                    x = float(q.get("x", [0])[0])
                    y = float(q.get("y", [0])[0])
                    info = server._probe(x, y) or {"miss": "hit the skybox"}
                    self._send("application/json", json.dumps(info).encode())
                else:
                    self._send("text/html", _PAGE.encode())

        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self.port = self._httpd.server_address[1]

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        """Stop serving and close the socket."""
        self._httpd.shutdown()
        self._httpd.server_close()

    def update(self, image_linear: np.ndarray, status: dict | None = None):
        """Push a new frame (linear f32[H,W,3]); encoded gamma-corrected."""
        rgb = color_mod.to_u8_gamma(torch.from_numpy(np.asarray(image_linear, np.float32)))
        png = encode_png(rgb.numpy())
        with self._lock:
            self._png = png
            if status is not None:
                self._status = status
