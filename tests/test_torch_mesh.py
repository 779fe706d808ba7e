"""The port's OBJ loader and mesh scenes against the JAX package's: the same
files and calls must give the same arrays and the same scene tables,
cluster tables and BVH included, bit for bit."""

import numpy as np
import pytest
import torch

from rt_tpu import scenes as jscenes
from rt_tpu.io.obj_loader import load_obj as j_load_obj
from rt_tpu_torch import scenes
from rt_tpu_torch.io.obj_loader import load_obj
import torch_cluster_cases as cases  # tests/torch_cluster_cases.py
from tools.gen_fixtures import make_obj_mesh

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _jax_native_builder():
    """The JAX side's tables come from its native BVH builder, as the
    port's do from the port's copy."""
    assert cases.load_jax_native(), "the JAX package's native BVH builder did not load"

# Quads (fan-triangulated), texture coordinates, negative indices, two
# groups, and a face without texture coordinates in the second group.
HAND_OBJ = """# hand-written
o first
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0.5
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 2/2 3/3 4/4
f -4/-4 -2/-2 -1/-1
g second
v 2 0 1
v 3 0 1
v 3 1 1
f 5 6 7
f 5//1 7//1 6//1
"""


@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    """make_obj_mesh(res=24): 1,104 triangles with texture coordinates."""
    path = tmp_path_factory.mktemp("mesh") / "blob.obj"
    assert make_obj_mesh(str(path), res=24) == 1104
    return str(path)


def _same_models(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["name"] == r["name"]
        np.testing.assert_array_equal(g["vertices"], r["vertices"])
        assert (g["uvs"] is None) == (r["uvs"] is None)
        if r["uvs"] is not None:
            np.testing.assert_array_equal(g["uvs"], r["uvs"])


def test_load_obj_fixture(blob):
    got = load_obj(blob)
    _same_models(got, j_load_obj(blob))
    assert got[0]["vertices"].shape == (1104, 3, 3) and got[0]["uvs"].shape == (1104, 3, 2)


def test_load_obj_hand_written(tmp_path):
    path = tmp_path / "hand.obj"
    path.write_text(HAND_OBJ)
    m = scenes.scale_rotate_mat(0.0, 90.0, 90.0, 2.0)
    for kw in ({}, {"centered": True}, {"transform": m}):
        got = load_obj(str(path), **kw)
        _same_models(got, j_load_obj(str(path), **kw))
    assert [len(model["vertices"]) for model in got] == [3, 2]
    assert got[0]["uvs"] is not None and got[1]["uvs"] is None


@pytest.mark.parametrize("args", [(0.0, 90.0, 90.0, 12.0), (0.0, -90.0, -90.0, 0.6),
                                  (90.0, 0.0, 0.0, 0.02), (33.0, -12.5, 71.0, 1.7)])
def test_scale_rotate_mat(args):
    got = scenes.scale_rotate_mat(*args)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jscenes.scale_rotate_mat(*args))


@pytest.mark.parametrize("style", ["plaster", "metal", "glass"])
def test_mesh_with_area_light_tables(blob, style):
    got = scenes.mesh_with_area_light(blob, mesh_style=style)
    ref = jscenes.mesh_with_area_light(blob, mesh_style=style)
    assert got.clusters is not None and got.bvh is not None and got.num_triangles == 1108
    cases.assert_same_scene(got, ref)


def test_mesh_scene_tables(blob):
    paths = {"red_metal": blob, "frosted_glass": blob, "unknown": blob}
    cases.assert_same_scene(scenes.mesh_scene(paths), jscenes.mesh_scene(paths))


def test_mesh_scene_reference_tables(blob, tmp_path):
    """Two of the five slots present (the others skipped), each placed by
    its scale_rotate_mat."""
    import shutil

    shutil.copy(blob, tmp_path / "teapot.obj")
    shutil.copy(blob, tmp_path / "Nefertiti.obj")
    got = scenes.mesh_scene_reference(str(tmp_path))
    assert got.num_triangles == 2 + 2 * 1104
    cases.assert_same_scene(got, jscenes.mesh_scene_reference(str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        scenes.mesh_scene_reference(str(tmp_path), missing_ok=False)


def test_cover_scene_bulk_branch():
    """cover_scene above 2500 cells draws in bulk (2,704 cells here): a
    clustered sphere scene, identical to the JAX package's."""
    got = scenes.cover_scene(26, 26, scenes.cam1(32, 24), z=-0.2, seed=0)
    ref = jscenes.cover_scene(26, 26, jscenes.cam1(32, 24), z=-0.2, seed=0)
    assert got.num_spheres > 2048 and got.clusters is not None
    cases.assert_same_scene(got, ref)
