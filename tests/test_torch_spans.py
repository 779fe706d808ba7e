"""The package's spans (``profiling.span``): ``rt.*`` ranges at its layer
boundaries, recorded only while a ``torch.profiler`` profile records.

Without a profiler a span enters no ``record_function``; under one, a frame,
a sweep, the set-up steps and the wavefront's iterations record their spans,
nested as the layers are; the images do not change.  The ``cuda`` case holds
the megakernel wrappers' two spans around K1 and K5 on the card.  This file
imports nothing of the JAX package, so that the ``cuda`` case also runs on a
machine without the JAX package's dependencies.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rt_tpu_torch import _build, megakernel, profiling, scenes, wavefront
from rt_tpu_torch.config import ProgressiveSchedule, RenderConfig
from rt_tpu_torch.fixtures import make_glb_armor
from rt_tpu_torch.io.gltf_loader import add_gltf_to_scene
from rt_tpu_torch.progressive import ProgressiveRenderer
from rt_tpu_torch.render import render_image, render_pixel_colors
from rt_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
W, H = 16, 9
CFG = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=4, seed=11)
SCHEDULE = ProgressiveSchedule(ramp=(1, 2), sustain_64=0, sustain_128=0, sustain_256=0)


def _cover():
    return scenes.cover_scene(3, 3, scenes.cam1(W, H), z=-0.2, seed=0)


def _mesh(tmp_path):
    """A glTF scene with cluster tables and a BVH (360 triangles)."""
    path = str(tmp_path / "mesh.glb")
    make_glb_armor(path, res=10, n_parts=2)
    b = SceneBuilder()
    add_gltf_to_scene(b, path)
    return b.build()


def _recorded(fn, cuda: bool = False):
    """(fn(), the profile's ``rt.*`` host ranges as (name, start, end) by
    start, its events)."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    spans = sorted(((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in events
                    if ev.device_type() == DeviceType.CPU and ev.name().startswith("rt.")),
                   key=lambda s: (s[1], -s[2]))
    return out, spans, events


def _parents(spans) -> list[tuple[str, str | None]]:
    """(name, the innermost enclosing span's name) of each span."""
    out = []
    for i, (name, s, e) in enumerate(spans):
        around = [o for j, o in enumerate(spans) if j != i and o[1] <= s and e <= o[2]]
        out.append((name, max(around, key=lambda o: o[1])[0] if around else None))
    return out


def test_no_profiler_enters_no_record_function(monkeypatch, tmp_path):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b", 3)  # one shared null context
    scene = _mesh(tmp_path)
    scene.to("meta")
    cover = _cover()
    render_image(cover, scenes.cam1(W, H), CFG, device="cpu")
    pr = ProgressiveRenderer(cover, scenes.cam1(W, H), CFG, schedule=SCHEDULE, engine="mega",
                             checkpoint_path=str(tmp_path / "p.npz"), device="cpu")
    pr.run()
    render_pixel_colors(cover, scenes.cam1(W, H), CFG.replace(renderer="wavefront"),
                        device="cpu", spp=1)


def test_frame_spans_nest_and_leave_the_image_alone():
    scene, cam = _cover(), scenes.cam1(W, H)
    plain, _ = render_image(scene, cam, CFG, device="cpu")
    (img, _), spans, _ = _recorded(lambda: render_image(scene, cam, CFG, device="cpu"))
    assert _parents(spans) == [("rt.render.frame", None),
                               ("rt.render.dispatch", "rt.render.frame"),
                               ("rt.render.fetch", "rt.render.frame")]
    np.testing.assert_array_equal(img, plain)


def test_sweep_spans_nest_and_leave_the_image_alone(tmp_path):
    scene, cam = _cover(), scenes.cam1(W, H)

    def sweeps(name):
        pr = ProgressiveRenderer(scene, cam, CFG, schedule=SCHEDULE, engine="mega",
                                 checkpoint_path=str(tmp_path / name), device="cpu")
        return [pr.step(), pr.step()], pr

    plain_metrics, plain = sweeps("a.npz")
    (metrics, pr), spans, _ = _recorded(lambda: sweeps("b.npz"))
    step = [("rt.progressive.step", None)] + [
        (f"rt.progressive.{k}", "rt.progressive.step")
        for k in ("dispatch", "accumulate", "fetch", "report", "checkpoint")]
    assert _parents(spans) == step + step
    np.testing.assert_array_equal(pr.state.accum, plain.state.accum)
    for m in metrics:
        assert 0.0 < m["sweep_s"] and m["mray_per_s"] == pytest.approx(
            m["sweep_spp"] * W * H / 1e6 / m["sweep_s"])
    assert [set(m) for m in metrics] == [set(m) for m in plain_metrics]


def test_set_up_spans(tmp_path):
    scene, spans, _ = _recorded(lambda: _mesh(tmp_path))
    assert _parents(spans) == [("rt.gltf.load", None), ("rt.gltf.images", "rt.gltf.load"),
                               ("rt.scene.build", None), ("rt.scene.atlas", "rt.scene.build"),
                               ("rt.scene.clusters", "rt.scene.build"),
                               ("rt.scene.bounds", "rt.scene.build"),
                               ("rt.scene.bvh", "rt.scene.build")]
    _, spans, _ = _recorded(lambda: scene.to("cpu"))
    assert spans == []  # nothing moves
    _, spans, _ = _recorded(lambda: scene.to("meta"))
    assert [s[0] for s in spans] == ["rt.scene.upload"]


def test_wavefront_iteration_spans():
    scene, cam = _cover(), scenes.cam1(W, H)
    cfg = CFG.replace(renderer="wavefront")
    plain = render_pixel_colors(scene, cam, cfg, device="cpu", spp=1)
    before = wavefront.COUNTS["iterations"]
    img, spans, _ = _recorded(lambda: render_pixel_colors(scene, cam, cfg, device="cpu", spp=1))
    iterations = wavefront.COUNTS["iterations"] - before
    assert iterations > 0
    assert [s[0] for s in spans] == ["rt.wavefront.iteration"] * iterations
    torch.testing.assert_close(img, plain, rtol=0, atol=0)


def test_cli_trace_writes_the_spans(tmp_path):
    trace, out = tmp_path / "t.json", tmp_path / "t.png"
    proc = subprocess.run(
        [sys.executable, "-m", "rt_tpu_torch.cli", "--scene", "cover", "--size", "16x9",
         "--spp", "1", "--max-depth", "4", "--device", "cpu", "--trace", str(trace),
         "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"rt.scene.build", "rt.render.frame"} <= names
    assert out.exists()


@pytest.mark.cuda
def test_megakernel_wrapper_spans_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cam = scenes.cam1(W, H)
    monkeypatch.setattr(_build, "_lib", None)
    _, spans, _ = _recorded(_build.library)
    assert [s[0] for s in spans] == ["rt.kernels.build"]
    for scene, counter in ((_cover(), "LAUNCHES"), (_mesh(tmp_path), "LAUNCHES_CLUSTERED")):
        scene.to("cuda")
        run = lambda: megakernel.render_megakernel(scene, cam, CFG, 2, 0, 7)
        plain = run()
        before = getattr(megakernel, counter)
        out, spans, events = _recorded(run, cuda=True)
        assert getattr(megakernel, counter) == before + 1
        assert [s[0] for s in spans] == ["rt.megakernel.prepare", "rt.megakernel.launch"]
        assert spans[0][2] <= spans[1][1]
        # The device's copies of the spans are user annotations, not operations.
        on_card = [ev for ev in events
                   if ev.device_type() == DeviceType.CUDA and ev.name().startswith("rt.")]
        assert all(ev.is_user_annotation() for ev in on_card)
        torch.testing.assert_close(out, plain, rtol=0, atol=0)
