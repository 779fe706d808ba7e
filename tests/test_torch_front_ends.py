"""The port's front ends against the JAX package's: the click probe
(debug.py), the terminal preview (term_preview.py), the HTTP viewer
(viewer.py) and the CLI's ``--probe``, ``--serve`` and ``--term-preview``.
Serial CPU time: about 15 s.

Tolerances:
- ``debug_pixel``: every float at atol 1e-3, rtol 1e-3 (the megakernel
  parity tolerance, tests/test_megakernel.py), strings, ints and bools
  exactly, a miss (None) exactly;
- ``ansi_frame``: the JAX string exactly (the same numpy arithmetic);
- ``kitty_frame``: the same chunking protocol, and the PNG it carries
  decodes (``png_io.decode_png``) to the JAX frame's pixels exactly: the
  port encodes with the standard library and the JAX package with PIL, so
  the bytes differ and the pixels must not;
- the viewer: its routes answer on an ephemeral localhost port, and
  ``/frame.png`` decodes to ``color.to_u8_gamma`` of the frame pushed.
"""

import base64
import io
import json
import re
import urllib.request

import numpy as np
import pytest
import torch

from rt_tpu import scenes as jscenes
from rt_tpu import term_preview as jterm
from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.debug import debug_pixel as j_debug_pixel
from rt_tpu_torch import cli, color, scenes, term_preview
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.debug import debug_pixel
from rt_tpu_torch.io.png_io import decode_png
from rt_tpu_torch.progressive import ProgressiveRenderer
from rt_tpu_torch.viewer import PreviewServer

torch.set_num_threads(2)

TOL = dict(atol=1e-3, rtol=1e-3)


def _scenes(name):
    if name == "cover":
        jcam, tcam = jscenes.cam1(32, 24), scenes.cam1(32, 24)
        return (jscenes.cover_scene(4, 4, jcam, z=-0.2, seed=0), jcam,
                scenes.cover_scene(4, 4, tcam, z=-0.2, seed=0), tcam)
    jcam, tcam = jscenes.widecam(24, 16), scenes.widecam(24, 16)
    return jscenes.gen_checkered(), jcam, scenes.gen_checkered(), tcam


def _assert_probe_equal(got, ref):
    assert (got is None) == (ref is None)
    if ref is None:
        return
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, list):
            np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)
        elif isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-3, abs=1e-3), k
        else:
            assert got[k] == v and type(got[k]) is type(v), k


@pytest.mark.parametrize("name,xy,hit", [
    ("cover", (16, 20), True),   # a small sphere
    ("cover", (5, 15), True),    # the checkered ground triangles
    ("cover", (16, 2), True),    # a small sphere near the horizon
    ("cover", (4, 0), False),    # the sky
    ("checkered", (12, 10), True),
    ("checkered", (3, 0), False),
])
def test_debug_pixel_matches_jax(name, xy, hit):
    jscene, jcam, tscene, tcam = _scenes(name)
    for seed in (0, 7):
        ref = j_debug_pixel(jscene, jcam, *xy, JConfig(seed=seed))
        got = debug_pixel(tscene, tcam, *xy, RenderConfig(seed=seed), device="cpu")
        assert (got is not None) == hit
        _assert_probe_equal(got, ref)
        json.dumps(got)  # plain values, as the CLI and the viewer send them


def test_debug_ray_is_the_pixel_center():
    cam = scenes.cam1(32, 24)
    org, dirn = cam.debug_ray(3.0, 5.0)
    assert torch.equal(org, cam.center)
    np.testing.assert_allclose(
        (org + dirn).numpy(), (cam.pixel00_loc + 3.0 * cam.pixel_du + 5.0 * cam.pixel_dv).numpy(),
        rtol=1e-6, atol=1e-6)


def _gradient(h=20, w=40):
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    return np.concatenate([y + 0 * x, x + 0 * y, 0.5 + 0 * (x + y)], axis=2).clip(0, 1)


@pytest.mark.parametrize("shape,cols", [((20, 40), 20), ((4, 4), 4), ((37, 53), 100)])
def test_ansi_frame_matches_jax(shape, cols):
    img = _gradient(*shape) * 1.3  # some values above 1 clip
    assert term_preview.ansi_frame(img, max_cols=cols) == jterm.ansi_frame(img, max_cols=cols)


def _kitty_chunks(frame: str):
    return re.findall(r"\x1b_G([^;]*);([^\x1b]*)\x1b\\", frame)


@pytest.mark.parametrize("shape", [(16, 16), (64, 128), (150, 200)])
def test_kitty_frame_decodes_to_jax_pixels(shape):
    rs = np.random.default_rng(shape[0])
    img = rs.uniform(0.0, 1.2, (*shape, 3)).astype(np.float32)  # noisy: many 4096-byte chunks
    got, ref = _kitty_chunks(term_preview.kitty_frame(img)), _kitty_chunks(jterm.kitty_frame(img))
    ctrl = [c for c, _ in got]
    assert ctrl[0].startswith("a=T,f=100,m=") and ctrl[-1].endswith("m=0")
    assert all(c.endswith("m=1") for c in ctrl[:-1])
    assert all(len(p) == 4096 for _, p in got[:-1]) and 0 < len(got[-1][1]) <= 4096
    decode = lambda chunks: decode_png(base64.standard_b64decode("".join(p for _, p in chunks)))
    np.testing.assert_array_equal(decode(got), decode(ref))
    assert decode(got).shape == (*shape, 3)


def test_terminal_preview_updates_in_place():
    out = io.StringIO()
    tp = term_preview.TerminalPreview(mode="ansi", max_cols=16, stream=out)
    tp.update(_gradient(), {"pass": 1, "mray_per_s": 12.3456})
    first = out.getvalue()
    assert "pass=1" in first and "mray_per_s=12.3" in first
    tp.update(_gradient(), {"pass": 2})
    second = out.getvalue()[len(first):]
    assert second.startswith("\x1b[") and "F\x1b[J" in second[:12] and "pass=2" in second
    kitty = io.StringIO()
    term_preview.TerminalPreview(mode="kitty", stream=kitty).update(_gradient())
    assert kitty.getvalue().startswith("\x1b_Ga=T,f=100,")


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def test_viewer_routes():
    server = PreviewServer(0, probe=lambda x, y: {"x": x, "y": y} if x > 0 else None).start()
    try:
        base = f"http://localhost:{server.port}"
        assert "rt_tpu preview" in _get(base).decode()
        with pytest.raises(urllib.error.HTTPError, match="404"):
            _get(base + "/frame.png")  # no sweep yet
        frame = np.random.default_rng(0).uniform(0, 1.5, (6, 9, 3)).astype(np.float32)
        server.update(frame, {"sweep": 1})
        png = _get(base + "/frame.png?123")
        np.testing.assert_array_equal(decode_png(png),
                                      color.to_u8_gamma(torch.from_numpy(frame)).numpy())
        assert json.loads(_get(base + "/status")) == {"sweep": 1}
        assert json.loads(_get(base + "/probe?x=1&y=2")) == {"x": 1.0, "y": 2.0}
        assert json.loads(_get(base + "/probe?x=0&y=2")) == {"miss": "hit the skybox"}
    finally:
        server.stop()


def test_viewer_serves_progressive_sweeps():
    """``PreviewServer.update`` as ``ProgressiveRenderer.run``'s on_sweep,
    with the probe wired to ``debug_pixel``, as ``cli --serve`` wires them."""
    camera = scenes.cam1(24, 16)
    scene = scenes.cover_scene(3, 3, camera, z=-0.2, seed=0)
    cfg = RenderConfig(width=24, height=16, max_depth=6)
    server = PreviewServer(0, probe=lambda x, y: debug_pixel(scene, camera, x, y, cfg,
                                                              device="cpu")).start()
    try:
        base = f"http://localhost:{server.port}"
        seen = []

        def on_sweep(image, metrics):
            server.update(image, metrics)
            seen.append((image.copy(), decode_png(_get(base + "/frame.png"))))

        image = ProgressiveRenderer(scene, camera, cfg, device="cpu").run(max_passes=2,
                                                                          on_sweep=on_sweep)
        assert len(seen) == 2
        for img, served in seen:
            np.testing.assert_array_equal(served, color.to_u8_gamma(torch.from_numpy(img)).numpy())
        np.testing.assert_array_equal(seen[-1][0], image)
        assert json.loads(_get(base + "/status"))["total_spp"] == 3
        probe = json.loads(_get(base + "/probe?x=12&y=14"))
        _assert_probe_equal(probe, debug_pixel(scene, camera, 12, 14, cfg, device="cpu"))
    finally:
        server.stop()


def test_cli_probe_matches_debug_pixel(capsys):
    assert cli.main(["--scene", "checkered", "--size", "24x16", "--camera", "widecam",
                     "--probe", "12,10", "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    ref = j_debug_pixel(jscenes.gen_checkered(), jscenes.widecam(24, 16), 12.0, 10.0, JConfig())
    _assert_probe_equal(info, ref)
    assert cli.main(["--scene", "checkered", "--size", "24x16", "--camera", "widecam",
                     "--probe", "3,0", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == {"miss": "hit the skybox"}


def test_cli_term_preview_and_serve(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TERM", "xterm-256color")  # the ANSI encoding ("kitty" picks the other)
    out = tmp_path / "p.png"
    assert cli.main(["--scene", "cover", "--size", "24x16", "--max-depth", "6", "--progressive",
                     "--passes", "2", "--term-preview", "--serve", "0", "--device", "cpu",
                     "--out", str(out)]) == 0
    captured = capsys.readouterr()
    assert re.search(r"preview at http://localhost:\d+", captured.err)
    frames = captured.out.split("\x1b[38;2;")
    assert len(frames) > 2 * 12  # two frames of 12 columns' cells at least
    assert "\x1b[J" in captured.out and "total_spp=3" in captured.out
    with open(out, "rb") as f:
        assert decode_png(f.read()).shape == (16, 24, 3)
