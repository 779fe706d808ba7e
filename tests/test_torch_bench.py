"""The port's bench scripts (bench_cuda.py, bench_grad_cuda.py,
bench_scenes_cuda.py, cluster_bench_cuda.py, bench_scaling_cuda.py) on the
CPU at tiny sizes, and the fixtures they render.

- Each script's ``main`` on ``device="cpu"`` prints the JAX script's
  metric names (bench.py, bench_grad.py, bench_scenes.py) with finite
  values.
- bench_cuda's route (``render_pixel_colors`` of the bench cover scene) on
  a 64x36 crop of cam1 at 1 spp against the JAX flat megakernel in
  interpret mode at atol 1e-3, rtol 1e-3, the megakernel parity tolerance,
  on every pixel where the JAX package's two renderers agree with each
  other (see the test).
- Config 5's --quick run on a small car-class glb: a checkpoint exists at
  the midpoint, the fresh renderer resumes from it, and the final
  accumulator equals an uninterrupted run's bit for bit.
- The OBJ fixtures are byte-equal to tools/gen_fixtures.py's, and the glb
  fixture differs from its PNG bytes only.

Serial CPU time of this file: about 30 s.
"""

import base64
import filecmp
import json
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_cuda
import bench_grad_cuda
import bench_scaling_cuda
import bench_scenes_cuda
import cluster_bench_cuda
from rt_tpu import scenes as jscenes
from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.megakernel import render_megakernel as j_render_megakernel
from rt_tpu.wavefront import _render_generic
from rt_tpu_torch import fixtures, scenes
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.io import png_io
from rt_tpu_torch.progressive import ProgressiveRenderer
from rt_tpu_torch.render import render_pixel_colors
from tools import gen_fixtures

torch.set_num_threads(2)

SCENE_METRICS = [
    "mray_per_s_config2_cover_textures_d8_400x225_640spp",
    "mray_per_s_config3_skull_class_obj_area_light_800x450_64spp",
    "mray_per_s_config3b_heightfield_obj_area_light_800x450_64spp",
    "mray_per_s_config4_armor_class_gltf_hw_sky_800x450_64spp",
    "mray_per_s_config5_night_car_class_1080p_8spp_progressive",
]


def small_fixtures(directory):
    """ensure_fixtures' four files, written small under their names."""
    directory.mkdir(exist_ok=True)
    fixtures.make_obj_mesh(str(directory / "skull_class.obj"), res=10)
    fixtures.make_obj_heightfield(str(directory / "heightfield.obj"), 8, 8)
    fixtures.make_glb_armor(str(directory / "armor_class.glb"), res=10, n_parts=2)
    fixtures.make_glb_armor(str(directory / "car_class.glb"), res=10, n_parts=2, seed=7)
    return fixtures.ensure_fixtures(str(directory))


def json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("script", ["bench", "bench_grad"])
def test_bench_main_on_cpu(script, capsys):
    if script == "bench":
        assert bench_cuda.main(["--device", "cpu", "--size", "32x18", "--spp", "1",
                                "--trials", "1"]) == 0
        metric, unit = "mray_per_s_cover_400x225_640spp", "Mray/s"
    else:
        assert bench_grad_cuda.main(["--device", "cpu", "--size", "16x9", "--reps", "1"]) == 0
        metric, unit = "pixel_grad_backward_s_400x225_1spp", "s"
    (rec,) = json_lines(capsys.readouterr().out)
    assert rec["metric"] == metric and rec["unit"] == unit and rec["device"] == "cpu"
    # Values are rounded as the JAX scripts round them, so a tiny CPU run
    # may print 0.0 Mray/s.
    assert np.isfinite(rec["value"]) and rec["value"] >= 0 and np.isfinite(rec["vs_baseline"])


def test_bench_scenes_main_on_cpu(tmp_path, capsys):
    small_fixtures(tmp_path / "fx")
    assert bench_scenes_cuda.main(["--device", "cpu", "--fixtures", str(tmp_path / "fx"),
                                   "--size", "16x9", "--spp", "1", "--quick"]) == 0
    recs = json_lines(capsys.readouterr().out)
    assert [r["metric"] for r in recs] == SCENE_METRICS
    assert all(r["unit"] == "Mray/s" and np.isfinite(r["value"]) and r["value"] >= 0
               and r["wall_s"] >= 0 and r["device"] == "cpu" for r in recs)
    assert recs[-1]["resumed_mid_run"] is True


def test_cluster_bench_main_on_cpu(tmp_path, capsys):
    """cluster_bench_cuda.py's scenes on the CPU at 16x9 and 1 spp: the 40k
    sphere cover (cluster tables, K5's plain version), the height field
    and the blob: tools/cluster_bench.py's line and the set-up line for
    each."""
    small_fixtures(tmp_path / "fx")
    for which in ("40k", "heightfield", "mesh"):
        assert cluster_bench_cuda.main([which, "--device", "cpu", "--size", "16x9", "--spp", "1",
                                        "--bin", "auto", "--fixtures", str(tmp_path / "fx")]) == 0
    out = capsys.readouterr().out
    lines = re.findall(r"^(.+): (\d+\.\d\d) Mray/s \((\d+\.\d\d) s, prims=(\d+)\)$", out, re.M)
    assert [name for name, *_ in lines] == ["40k spheres", "100k-tri heightfield",
                                            "100k-tri blob+light"]
    assert int(lines[0][3]) == 39_963 and all(float(v) >= 0 for _, v, _, _ in lines)
    setup = re.findall(r"^(.+): scene (\S+) s \(SceneBuilder.build (\S+) s\), (\S+) MB of "
                       r"tables on cpu \((\d+) cluster rows", out, re.M)
    assert [name for name, *_ in setup] == [name for name, *_ in lines]
    assert all(0 <= float(b) <= float(t) and float(mb) > 0 for _, t, b, mb, _ in setup)


def test_bench_scaling_main_on_cpu(capsys):
    """bench_scaling_cuda.py in one process (a gloo group of one): the
    1-device row of bench_scaling.py."""
    assert bench_scaling_cuda.main(["--device", "cpu", "--size", "16x9", "--spp", "1"]) == 0
    (rec,) = json_lines(capsys.readouterr().out)
    assert rec["devices"] == 1 and rec["scaling_vs_1dev"] is None
    assert rec["speedup_vs_1dev"] is None
    assert rec["mray_per_s"] >= 0 and rec["wall_s"] > 0


def test_bench_route_cover_crop_matches_jax():
    """bench_cuda's frame and route on a 64x36 crop: the cover scene 11x11
    at depth 50, 1 spp, key 0, against the JAX flat megakernel in interpret
    mode.  At depth 50 through glass a few paths decorrelate on last-bit
    differences (XLA:CPU fuses multiply-adds, PyTorch does not): the JAX
    package's own two renderers, the megakernel and _render_generic,
    disagree with each other on 4 of the 2,304 pixels.  Every pixel where
    they agree must match."""
    w, h = 64, 36
    scene, camera, cfg = bench_cuda.bench_frame(w, h)
    assert (camera.image_width, cfg.width, cfg.max_depth, scene.num_spheres) == (w, w, 50, 447)
    got = render_pixel_colors(scene, camera, cfg, device="cpu", spp=1).numpy().reshape(-1, 3)
    jcam = jscenes.cam1(w, h)
    jscene = jscenes.cover_scene(11, 11, jcam, z=-0.2, seed=0)
    jcfg = JConfig(width=w, height=h, samples_per_pixel=10, max_depth=50)
    ref = np.asarray(j_render_megakernel(jscene, jcam, jcfg, 1, 0, jax.random.key(0), lanes=256,
                                         tile_pixels=256, packed_select=False, interpret=True))
    generic = np.asarray(_render_generic(jscene, jcam, jnp.arange(w * h, dtype=jnp.int32), jcfg,
                                         1, jnp.int32(0), jax.random.key(0)))
    outside = lambda a, b: (np.abs(a - b) > 1e-3 + 1e-3 * np.abs(b)).any(axis=1)
    unstable = outside(generic, ref)
    assert unstable.sum() <= 0.005 * w * h
    np.testing.assert_allclose(got[~unstable], ref[~unstable], atol=1e-3, rtol=1e-3)
    assert not (outside(got, generic) & ~unstable).any()


def test_config5_quick_resumes_at_the_midpoint(tmp_path):
    """--quick (8 spp, two 4-spp sweeps) checkpoints every sweep, so the
    fresh renderer at the midpoint finds the first sweep's checkpoint; the
    resumed run ends where an uninterrupted one does, bit for bit."""
    fx = small_fixtures(tmp_path / "fx")
    scene, camera, cfg = bench_scenes_cuda.config5_setup(fx, (12, 8))
    schedule, every = bench_scenes_cuda.config5_schedule(8)
    assert schedule.passes() == (4, 4) and every == 1
    assert bench_scenes_cuda.config5_schedule(256)[1] == 16
    ckpt = str(tmp_path / "c5.npz")
    pr, spp, _ = bench_scenes_cuda.run_config5(scene, camera, cfg, 8, ckpt, "cpu")
    assert spp == 8 and pr.state.pass_index == 2
    whole = ProgressiveRenderer(scene, camera, cfg, schedule=schedule, engine="mega", device="cpu")
    whole.run()
    assert whole.engine == "mega"
    np.testing.assert_array_equal(pr.state.accum, whole.state.accum)
    # A checkpoint of the first sweep only: a fresh renderer resumes there.
    first = ProgressiveRenderer(scene, camera, cfg, schedule=schedule, engine="mega",
                                checkpoint_path=str(tmp_path / "one.npz"), device="cpu")
    first.run(max_passes=1)
    again = ProgressiveRenderer(scene, camera, cfg, schedule=schedule, engine="mega",
                                checkpoint_path=str(tmp_path / "one.npz"), device="cpu")
    assert again.state.total_spp == 4 and again.state.pass_index == 1


@pytest.mark.parametrize("name", ["obj_mesh", "heightfield"])
def test_obj_fixtures_byte_equal_tools(name, tmp_path):
    mine, theirs = str(tmp_path / "port.obj"), str(tmp_path / "tools.obj")
    if name == "obj_mesh":
        assert fixtures.make_obj_mesh(mine, res=16) == gen_fixtures.make_obj_mesh(theirs, res=16)
    else:
        assert (fixtures.make_obj_heightfield(mine, 9, 7)
                == gen_fixtures.make_obj_heightfield(theirs, 9, 7))
    assert filecmp.cmp(mine, theirs, shallow=False)


def _glb_parts(path):
    with open(path, "rb") as f:
        blob = f.read()
    length, _ = struct.unpack("<II", blob[12:20])
    doc = json.loads(blob[20 : 20 + length])
    return doc, blob[20 + length + 8 :]


def test_glb_fixture_differs_from_tools_in_png_bytes_only(tmp_path):
    mine, theirs = str(tmp_path / "port.glb"), str(tmp_path / "tools.glb")
    assert (fixtures.make_glb_armor(mine, res=8, n_parts=3)
            == gen_fixtures.make_glb_armor(theirs, res=8, n_parts=3) == 3 * 7 * 8 * 2)
    (doc, bin_), (ref_doc, ref_bin) = _glb_parts(mine), _glb_parts(theirs)
    assert bin_ == ref_bin
    images, ref_images = doc.pop("images"), ref_doc.pop("images")
    assert doc == ref_doc
    for im, ref in zip(images, ref_images, strict=True):
        texels = [png_io.decode_png(base64.b64decode(x["uri"].split(",", 1)[1])) for x in (im, ref)]
        np.testing.assert_array_equal(*texels)
