"""Port parity of scene construction, conversion and image I/O.

Scene tables must be bit-equal to the JAX package's builder for the same
calls: the port renders from them and its tests compare renders per sample.
"""

import jax
import numpy as np
import pytest
import torch

from rt_tpu import scenes as jscenes
from rt_tpu_torch import convert, scenes
from rt_tpu_torch.io import read_ppm, write_png, write_ppm
from rt_tpu_torch.scene import TABLES, SceneBuilder

torch.set_num_threads(2)


def _assert_same_scene(got, ref):
    for name in TABLES:
        r = getattr(ref, name)
        g = getattr(got, name)
        if r is None:
            assert g is None, name
            continue
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    assert (got.num_spheres, got.num_triangles, got.has_image_textures) == (
        ref.num_spheres, ref.num_triangles, ref.has_image_textures)
    for name in ("sun_direction", "turbidity", "exposure"):
        np.testing.assert_array_equal(getattr(got.sky, name).numpy(), np.asarray(getattr(ref.sky, name)))
    assert (got.sky.hw_params is None) == (ref.sky.hw_params is None)
    assert got.sky.cos_gamma_as_angle == ref.sky.cos_gamma_as_angle


SCENES = {
    "cover_4x4": (lambda m: m.cover_scene(4, 4, m.cam1(32, 24), z=-0.2, seed=0)),
    "cover_11x11": (lambda m: m.cover_scene(11, 11, m.cam1(400, 225), z=-0.2, seed=0)),
    "triangles": (lambda m: m.triangle_scene()),
    "textured": (lambda m: m.textured_spheres_scene()),
    "earth": (lambda m: m.earth_scene()),
    "checkered": (lambda m: m.gen_checkered()),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_tables_bit_equal(name):
    _assert_same_scene(SCENES[name](scenes), SCENES[name](jscenes))


def test_convert_carries_jax_objects():
    jcam = jscenes.cam2(40, 30)
    jscene = jscenes.cover_scene(4, 4, jcam, z=-0.2, seed=3)
    host = jax.tree.map(np.asarray, jscene)
    got = convert.scene_from_arrays(host)
    _assert_same_scene(got, jscene)
    _assert_same_scene(scenes.cover_scene(4, 4, scenes.cam2(40, 30), z=-0.2, seed=3), jscene)
    cam = convert.camera_from_arrays(jax.tree.map(np.asarray, jcam))
    ref = scenes.cam2(40, 30)
    for field in ("center", "pixel00_loc", "pixel_du", "pixel_dv", "defocus_disk_u", "defocus_disk_v"):
        np.testing.assert_array_equal(getattr(cam, field).numpy(), np.asarray(getattr(jcam, field)))
        np.testing.assert_allclose(getattr(cam, field).numpy(), getattr(ref, field).numpy(), atol=1e-6, rtol=1e-6)
    assert cam.defocus_on and (cam.image_width, cam.image_height) == (40, 30)


def test_scene_moves_with_to():
    scene = scenes.gen_checkered()
    assert all(t.device.type == "cpu" for t in scene.buffers())
    assert scene.to("cpu") is scene and scene.device == torch.device("cpu")
    assert {name for name, _ in scene.named_buffers()} == set(TABLES)


def test_scenes_beyond_the_flat_slice_raise():
    """Scenes beyond the flat slice no longer raise: above 128 triangles or
    2048 primitives they get cluster tables, above 256 triangles or 4096
    primitives (or with use_bvh) a BVH, as in the JAX package
    (tests/test_torch_cluster.py holds the tables against it)."""
    b = SceneBuilder()
    mat = b.lambertian_rgb(0.5, 0.5, 0.5)
    for k in range(200):
        b.add_triangle((k, 0, 0), (k + 1, 0, 0), (k, 1, 0), mat)
    scene = b.build()
    assert scene.clusters is not None and scene.bvh is None
    b = SceneBuilder()
    mat = b.lambertian_rgb(0.5, 0.5, 0.5)
    for k in range(2049):
        b.add_sphere((k, 0, 0), 0.1, mat)
    scene = b.build()
    assert scene.clusters is not None and scene.bvh is None
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, b.lambertian_rgb(0.5, 0.5, 0.5))
    scene = b.build(use_bvh=True)
    assert scene.clusters is None and scene.bvh is not None
    assert scenes.cover_scene(60, 60).clusters is not None


def test_png_and_ppm_round_trip(tmp_path):
    from PIL import Image

    img = np.random.default_rng(4).uniform(0.0, 1.0, (18, 32, 3)).astype(np.float32)
    from rt_tpu.color import to_u8_gamma

    expected = np.asarray(to_u8_gamma(img))
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png").convert("RGB")), expected)
    write_ppm(str(tmp_path / "a.ppm"), img)
    np.testing.assert_array_equal(read_ppm(str(tmp_path / "a.ppm")), expected)
