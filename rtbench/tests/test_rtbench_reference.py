"""The frozen references compute what the program computes: at a tiny size
on the CPU, against the program's plain PyTorch paths.  (These tests import
the program; the references do not.)"""

import numpy as np
import torch

from rtbench import check, drivers
from rtbench.inputs import car

from conftest import tiny_cell


def _program(cell):
    config = cell["config_spec"]
    drivers.ensure_inputs(config)
    return drivers.build_scene(config, check.describe(config), {})


def test_cover_scene_tables_equal_the_programs_own_cover():
    from rt_tpu_torch import scenes

    scene, camera, _ = _program(tiny_cell("cover-final"))
    own = scenes.cover_scene(11, 11, scenes.cam1(16, 9), z=-0.2, seed=0)
    for name in ("sph_packed", "tri_packed", "shade_table", "atlas", "tex_color", "mat_fuzz",
                 "mat_ior"):
        assert torch.equal(getattr(scene, name), getattr(own, name)), name
    for name in ("center", "pixel00_loc", "pixel_du", "pixel_dv"):
        assert torch.equal(getattr(camera, name), getattr(scenes.cam1(16, 9), name)), name


def test_car_glb_decodes_as_the_programs_fixture(tmp_path):
    from rt_tpu_torch.fixtures import make_glb_armor
    from rt_tpu_torch.io.gltf_loader import load_gltf

    ours, theirs = str(tmp_path / "ours.glb"), str(tmp_path / "theirs.glb")
    car.write_glb(ours, res=10, n_parts=3, seed=7)
    make_glb_armor(theirs, res=10, n_parts=3, seed=7)
    a, b = load_gltf(ours), load_gltf(theirs)
    assert len(a) == len(b) == 3
    for pa, pb in zip(a, b):
        for key in ("vertices", "uvs", "base_color_image"):
            assert np.array_equal(pa[key], pb[key]), key
        assert pa["metallic"] == pb["metallic"] and pa["roughness"] == pb["roughness"]


def _frame_gap(name, spp, **kw):
    from rt_tpu_torch import render

    cell = tiny_cell(name, **kw)
    scene, camera, cfg = _program(cell)
    img, _ = render.render_image(scene, camera, cfg.replace(seed=4242), device="cpu", spp=spp)
    ref = check.Reference(cell["config_spec"], "cpu")
    pix = np.arange(ref.n_pixels)
    return np.abs(ref.frame_pixels(pix, spp, 4242) - img.reshape(-1, 3)).max()


def test_megakernel_path_on_the_cover():
    assert _frame_gap("cover-final", 2) < 1e-5


def test_megakernel_path_on_the_car():
    # The whole car (res 128, 162,560 triangles): K5's plain walk against
    # the reference's brute force.
    assert _frame_gap("car-preview", 2, tiny_scene=False) < 1e-5


def test_wavefront_progressive_on_the_cover():
    # The reference's per-sweep division (``divide``), which the wavefront
    # engine's sweeps take, on the cover's configuration.
    from rt_tpu_torch.config import ProgressiveSchedule
    from rt_tpu_torch.progressive import ProgressiveRenderer

    cell = tiny_cell("cover-final")
    scene, camera, cfg = _program(cell)
    pr = ProgressiveRenderer(scene, camera, cfg.replace(seed=99),
                             schedule=ProgressiveSchedule(ramp=(2, 2, 2), sustain_64=0,
                                                          sustain_128=0, sustain_256=0),
                             engine="wavefront", device="cpu")
    for _ in range(3):
        pr.step()
    ref = check.Reference(cell["config_spec"], "cpu")
    pix = np.arange(ref.n_pixels)
    want = ref.progressive_pixels(pix, 99, 3, 2, divide=True)
    assert np.abs(want - pr.state.image.reshape(-1, 3)).max() < 1e-5
