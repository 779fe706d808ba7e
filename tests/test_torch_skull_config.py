"""BASELINE config 3 on the port: the skull-class OBJ under an emissive area
light, the benchmark's configuration ``skull_area_light`` (cell
``blob-frames``), cut to a CPU test's size.

The program's scene is built as a benchmark run builds it (the OBJ written
once under ``build/rtbench/``, then the generator's program side: the OBJ
through ``io.obj_loader`` and ``scenes.mesh_with_area_light``), rendered
through K5's plain path; the plain reference (``rtbench.reference``, which
imports nothing of the port) recomputes seeded pixels from the raw
description.  The OBJ loader's spans and counter are checked here too.
"""

import filecmp
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rt_tpu_torch import fixtures, megakernel
from rt_tpu_torch.io import obj_loader
from rtbench import check, drivers, harness

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CELL = "blob-frames"
W, H = 16, 9
SEEDS = [2**31 + 12345, 7]
# At 2 spp hardly a path of the 48 pixels reaches the panel (2 of the 144
# pixels of a frame); at 16 spp about one pixel in ten does.
LIT_SPP = 16


@pytest.fixture(scope="module")
def tiny():
    """(config, its reference-side generator, the program's scene, camera
    and RenderConfig) of the cell's configuration cut to the generator's
    ``tiny`` scene and a 16x9 frame, built as a benchmark run builds it."""
    spec = harness.load_cell(CELL)["config_spec"]
    inputs = harness.load_generator(spec["scene"]["generator"])
    config = dict(spec, width=W, height=H, scene=inputs.tiny(spec["scene"]))
    drivers.ensure_inputs(config)
    scene, camera, cfg = drivers.build_scene(config, check.describe(config), {})
    return config, inputs, scene, camera, cfg


def _numbers(tiny, scene, seed, spp):
    """The cell's numbers for the program's frame of ``scene`` at ``spp``
    under render seed ``seed``, through K5's plain path, on 48 pixels drawn
    from the seed, against the reference."""
    config, _, _, camera, cfg = tiny
    img = megakernel.render_megakernel_plain(scene, camera, cfg, spp, 0, seed)
    ref = check.Reference(config, "cpu")
    pix = check.sample_pixels(seed, ref.n_pixels, 48, 0)
    return check.image_numbers(img.numpy()[pix], ref.frame_pixels(pix, spp, seed))


@pytest.mark.parametrize("seed,spp", [(SEEDS[0], 2), (SEEDS[1], 2), (SEEDS[0], LIT_SPP)])
def test_tiny_skull_agrees_with_the_reference(tiny, seed, spp):
    scene = tiny[2]
    assert scene.clusters is not None and scene.bvh is not None
    assert megakernel.eligible_clustered(scene, tiny[4])
    nums = _numbers(tiny, scene, seed, spp)
    limits = harness.load_cell(CELL)["check_spec"]["limits"]
    assert all(nums[k] <= v for k, v in limits.items()), nums


def test_a_dark_light_fails_the_check(tiny):
    """With the panel's radiance at 0 in the program's scene only, the same
    comparison at 16 spp fails: the emitter is on the path."""
    from rt_tpu_torch import scenes

    config, inputs = tiny[:2]
    scene = scenes.mesh_with_area_light(inputs.obj_path(config["scene"], drivers.BUILD_DIR),
                                        light_radiance=(0.0, 0.0, 0.0))
    nums = _numbers(tiny, scene, SEEDS[0], LIT_SPP)
    limits = harness.load_cell(CELL)["check_spec"]["limits"]
    assert all(nums[k] > 10 * v for k, v in limits.items()), nums


@pytest.mark.parametrize("key,value", [
    ("plaster", [0.9, 0.7, 0.85]),
    ("ground", {"z": -0.25}),
    ("light", {"triangles": [[[-1.5, -1.5, 4.5], [1.5, -1.5, 4.5], [0.0, 1.5, 4.5]]] * 2}),
    ("sky", {"turbidity": 3.0}),
])
def test_a_scene_the_program_side_does_not_build_is_refused(tiny, key, value):
    """The scene function fixes all but the OBJ and the radiance: a
    configuration that states another ground, plaster, panel or sky stops
    the build instead of reaching the reference alone."""
    config = tiny[0]
    sc = config["scene"]
    stated = dict(sc[key], **value) if isinstance(value, dict) else value
    changed = dict(config, scene=dict(sc, **{key: stated}))
    program_side = harness.load_generator(sc["generator"], "scenes")
    with pytest.raises(ValueError, match=key):
        program_side.build(changed, None, drivers.BUILD_DIR)
    assert program_side.build(config, None, drivers.BUILD_DIR).num_triangles == 2 + 264 + 2


def test_obj_equals_the_fixture_and_loads_to_the_description(tiny, tmp_path):
    config, inputs = tiny[:2]
    path = inputs.obj_path(config["scene"], drivers.BUILD_DIR)
    assert config["scene"]["res"] == 12
    fixture = str(tmp_path / "fixture.obj")
    n = fixtures.make_obj_mesh(fixture, res=12, seed=config["scene"]["seed"])
    assert filecmp.cmp(path, fixture, shallow=False)
    (model,) = obj_loader.load_obj(path)
    tri = check.describe(config)["triangles"]
    mesh = tri["material"] == 1
    assert mesh.sum() == n == 264
    got = np.stack([model["vertices"][:, k] for k in range(3)])
    want = np.stack([np.asarray(tri[k], np.float32)[mesh] for k in "abc"])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(model["uvs"].view(np.uint32),
                                  np.asarray(tri["uv"], np.float32)[mesh].view(np.uint32))


def test_obj_load_spans_and_counts(tmp_path):
    path = tmp_path / "quads.obj"
    # Two groups; a quad (two triangles) and a triangle.
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                    "o a\nf 1 2 3 4\no b\nf 1 2 3\n")
    before = dict(obj_loader.COUNTS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        models = obj_loader.load_obj(str(path))
    assert [len(m["vertices"]) for m in models] == [2, 1]
    counted = {k: obj_loader.COUNTS[k] - before[k] for k in before}
    assert counted == {"files": 1, "faces": 2, "triangles": 3}
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CPU and ev.name().startswith("rt.obj.")]
    spans = {ev.name(): (ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in events}
    assert sorted(spans) == ["rt.obj.assemble", "rt.obj.load", "rt.obj.parse"]
    s, e = spans["rt.obj.load"]
    assert all(s <= a and b <= e for a, b in (spans["rt.obj.parse"], spans["rt.obj.assemble"]))
    assert spans["rt.obj.parse"][1] <= spans["rt.obj.assemble"][0]
    # Without a profiler the loader gives the same arrays and still counts.
    again = obj_loader.load_obj(str(path))
    for m, n in zip(models, again):
        np.testing.assert_array_equal(m["vertices"], n["vertices"])
    assert obj_loader.COUNTS["files"] == before["files"] + 2


def test_cli_trace_of_an_obj_scene_shows_the_loader(tmp_path):
    obj, trace, out = tmp_path / "m.obj", tmp_path / "t.json", tmp_path / "m.png"
    fixtures.make_obj_mesh(str(obj), res=8)
    proc = subprocess.run(
        [sys.executable, "-m", "rt_tpu_torch.cli", "--scene", f"obj:{obj}", "--camera", "widecam",
         "--size", "16x9", "--spp", "1", "--max-depth", "2", "--device", "cpu",
         "--trace", str(trace), "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"rt.obj.load", "rt.obj.parse", "rt.obj.assemble", "rt.scene.build"} <= names
