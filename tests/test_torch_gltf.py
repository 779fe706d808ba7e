"""The port's glTF loader (rt_tpu_torch/io/gltf_loader.py) against the JAX
package's (rt_tpu/io/gltf_loader.py) on the CPU, and a glb frame under the
live sky through K5's plain version.

- ``load_gltf`` records equal exactly (every array bit for bit, with its
  dtype): on tests/test_loaders.py's minimal glTF (plain, textured, node
  transforms, GLB), on files with external buffers and images, an
  interleaved accessor, node matrices and hierarchies, and on the armor
  fixture as tools/gen_fixtures.py and rt_tpu_torch.fixtures write it;
- ``material_from_gltf`` in both ``compat_all_metal`` modes, and
  ``SceneBuilder.build``'s tables equal exactly on a small glb (res 12, 2
  parts: the shade table, the atlas, the cluster tables and the BVH), and
  on a file whose two materials share one image (it enters the atlas
  once);
- a 32x24, 2-spp, depth-6 frame of that glb under ``hosek(3.0, 0.3,
  0.8)``: K5's plain version against JAX's clustered megakernel in
  interpret mode with the expansion sweep and lane binning off, at atol
  2e-3 (rtol 1e-3) with no outlier pixel (tests/test_megakernel_cluster.py's
  ``_compare`` without its outlier allowance: with expansion off every
  candidate set is exact);
- ``cli --scene gltf:`` at 16x9 on the CPU.

Serial CPU time of this file: about 25 s.
"""

import base64
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from rt_tpu import scene as jscene
from rt_tpu import sky as jsky
from rt_tpu.camera import make_camera as j_make_camera
from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.io import gltf_loader as jgltf
from rt_tpu.megakernel import render_megakernel as j_render_megakernel
from rt_tpu_torch import fixtures, megakernel
from rt_tpu_torch import scene as tscene
from rt_tpu_torch.camera import make_camera
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.io import gltf_loader as tgltf
from rt_tpu_torch.io import png_io
from rt_tpu_torch.sky import SkyParams
from test_loaders import _minimal_gltf
import torch_cluster_cases as cases  # tests/torch_cluster_cases.py

torch.set_num_threads(2)
W, H = 32, 24


@pytest.fixture(autouse=True, scope="module")
def _jax_native_builder():
    """The JAX side's cluster tables come from its native BVH builder, as
    the port's do from the port's copy."""
    assert cases.load_jax_native(), "the JAX package's native BVH builder did not load"


def assert_same_records(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for key, want in r.items():
            have = g[key]
            if isinstance(want, np.ndarray):
                assert isinstance(have, np.ndarray) and have.dtype == want.dtype, key
                np.testing.assert_array_equal(have, want, err_msg=key)
            else:
                assert type(have) is type(want) and have == want, key


def to_glb(gltf_path, out_path):
    """tests/test_loaders.py's GLB container around a .gltf with one
    base64 buffer."""
    with open(gltf_path) as f:
        doc = json.load(f)
    uri = doc["buffers"][0].pop("uri")
    blob = base64.b64decode(uri.split(",", 1)[1])
    json_bytes = json.dumps(doc).encode()
    json_bytes += b" " * ((4 - len(json_bytes) % 4) % 4)
    blob += b"\0" * ((4 - len(blob) % 4) % 4)
    glb = b"glTF" + struct.pack("<II", 2, 12 + 8 + len(json_bytes) + 8 + len(blob))
    glb += struct.pack("<II", len(json_bytes), 0x4E4F534A) + json_bytes
    glb += struct.pack("<II", len(blob), 0x004E4942) + blob
    with open(out_path, "wb") as f:
        f.write(glb)
    return str(out_path)


def external_gltf(tmp_path):
    """Two meshes in a node hierarchy (a matrix node with a TRS child, and
    a second root instancing the child's mesh), an
    external .bin holding an interleaved POSITION/TEXCOORD_0 view with a
    byte stride, u8 indices, and an external PNG shared by two materials."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5]], np.float32)
    uv = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    inter = np.concatenate([pos, uv], axis=1).astype(np.float32)  # 20-byte stride
    idx = np.array([0, 1, 2, 1, 3, 2], np.uint8)
    blob = inter.tobytes() + idx.tobytes()
    (tmp_path / "mesh.bin").write_bytes(blob)
    pixels = np.random.default_rng(4).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    (tmp_path / "albedo.png").write_bytes(png_io.encode_png(pixels))
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(blob), "uri": "mesh.bin"}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": inter.nbytes, "byteStride": 20},
            {"buffer": 0, "byteOffset": inter.nbytes, "byteLength": idx.nbytes},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 1, "componentType": 5121, "count": 6, "type": "SCALAR"},
        ],
        "images": [{"uri": "albedo.png"}],
        "textures": [{"source": 0}, {"source": 0}],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}, "metallicFactor": 0.9,
                                      "roughnessFactor": 0.2}},
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 1}, "metallicFactor": 0.1}},
        ],
        "meshes": [
            {"name": "a", "primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                          "indices": 2, "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": 0}, "material": 1}]},
        ],
        "nodes": [
            {"mesh": 0, "matrix": [2, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0.5, 0, 1, 1],
             "children": [1]},
            {"mesh": 1, "translation": [0, 0, 2], "rotation": [0, 0, 0.3826834, 0.9238795],
             "scale": [1, 2, 1]},
            {"mesh": 1, "scale": [3, 3, 3]},  # a second instance of mesh 1
        ],
        "scenes": [{"nodes": [0, 2]}],
    }
    path = tmp_path / "ext.gltf"
    path.write_text(json.dumps(doc))
    return str(path)


def small_glb(directory, writer=fixtures):
    """The armor-class glb at res 12 with 2 parts (528 triangles)."""
    path = os.path.join(str(directory), "small.glb")
    writer.make_glb_armor(path, res=12, n_parts=2)
    return path


def small_glb_tools(directory):
    from tools import gen_fixtures

    return small_glb(directory, gen_fixtures)


FILES = {
    "plain": lambda d: _minimal_gltf(d),
    "textured": lambda d: _minimal_gltf(d, with_texture=True),
    "glb": lambda d: to_glb(_minimal_gltf(d, with_texture=True), d / "scene.glb"),
    "external": external_gltf,
    "armor_tools": small_glb_tools,
    "armor_port": small_glb,
}


@pytest.mark.parametrize("transforms", [False, True])
@pytest.mark.parametrize("name", list(FILES))
def test_load_gltf_records_equal_jax(name, transforms, tmp_path):
    path = FILES[name](tmp_path)
    ref = jgltf.load_gltf(path, apply_node_transforms=transforms)
    got = tgltf.load_gltf(path, apply_node_transforms=transforms)
    assert_same_records(got, ref)
    if name == "external":
        assert got[0]["base_color_image"] is got[1]["base_color_image"]  # the image cache
        assert len(got) == (3 if transforms else 2)


def test_armor_records_equal_across_writers(tmp_path):
    """The port's fixture (encode_png) and tools/gen_fixtures.py's (PIL)
    load to the same records: PNG is lossless."""
    (tmp_path / "t").mkdir()
    (tmp_path / "p").mkdir()
    ref = jgltf.load_gltf(small_glb_tools(tmp_path / "t"))
    got = tgltf.load_gltf(small_glb(tmp_path / "p"))
    assert_same_records(got, ref)
    assert all(r["base_color_image"] is not None for r in got)


@pytest.mark.parametrize("compat", [True, False])
def test_material_from_gltf_both_modes(compat, tmp_path):
    prims = {name: (jgltf.load_gltf(FILES[name](tmp_path)), tgltf.load_gltf(FILES[name](tmp_path)))
             for name in ("plain", "external")}
    jb, tb = jscene.SceneBuilder(), tscene.SceneBuilder()
    for ref, got in prims.values():
        for r, g in zip(ref, got):
            assert (tgltf.material_from_gltf(tb, g, compat)
                    == jgltf.material_from_gltf(jb, r, compat))
    kinds = [m.kind for m in tb._materials]
    assert kinds == [m.kind for m in jb._materials]
    assert [(m.texture, m.fuzz) for m in tb._materials] == [
        (m.texture, m.fuzz) for m in jb._materials]
    if compat:
        assert set(kinds) == {tscene.MAT_METAL}
    else:
        assert kinds == [tscene.MAT_LAMBERTIAN, tscene.MAT_METAL, tscene.MAT_LAMBERTIAN]


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("name", ["armor_port", "external"])
def test_built_tables_equal_jax(name, compat, tmp_path):
    path = FILES[name](tmp_path)
    jb, tb = jscene.SceneBuilder(), tscene.SceneBuilder()
    n_ref = jgltf.add_gltf_to_scene(jb, path, compat_all_metal=compat)
    assert tgltf.add_gltf_to_scene(tb, path, compat_all_metal=compat) == n_ref
    ref = jb.build().replace(sky=jsky.SkyParams.hosek(3.0, 0.3, 0.8))
    got = tb.build(sky=SkyParams.hosek(3.0, 0.3, 0.8))
    cases.assert_same_scene(got, ref)
    np.testing.assert_allclose(got.sky.hw_params.numpy(), np.asarray(ref.sky.hw_params),
                               atol=1e-6, rtol=1e-5)
    if name == "armor_port":
        assert got.clusters is not None and got.bvh is not None and got.num_triangles == 528
        assert tuple(got.atlas.shape) == (128, 64, 3)  # two textures, one each
    else:
        assert tuple(got.atlas.shape) == (6, 5, 3)  # the shared image once


def _camera(make):
    d, h = 5.5, 2.2
    return make((d, -d, h), (0.0, 0.0, 1.0), (0.0, 0.0, 1.0),
                focus_distance=float((2 * d * d + (h - 1) ** 2) ** 0.5), defocus_angle=0.0,
                image_width=W, image_height=H, vertical_fov=32.0)


def test_glb_frame_under_live_sky_matches_jax_interpret(tmp_path):
    path = small_glb(tmp_path)
    jb, tb = jscene.SceneBuilder(), tscene.SceneBuilder()
    jgltf.add_gltf_to_scene(jb, path)
    tgltf.add_gltf_to_scene(tb, path)
    js = jb.build().replace(sky=jsky.SkyParams.hosek(3.0, 0.3, 0.8))
    ts = tb.build(sky=SkyParams.hosek(3.0, 0.3, 0.8))
    jcfg = JConfig(width=W, height=H, samples_per_pixel=2, max_depth=6, expand_sweep="off",
                   bin_lanes="off")
    tcfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=6)
    assert megakernel.eligible_clustered(ts, tcfg) and ts.has_image_textures
    ref = np.asarray(j_render_megakernel(js, _camera(j_make_camera), jcfg, 2, 0,
                                         jax.random.key(0), lanes=256, tile_pixels=256,
                                         interpret=True))
    got = megakernel.render_megakernel(ts, _camera(make_camera), tcfg, 2, 0, 0).numpy()
    err = np.abs(got - ref) - (2e-3 + 1e-3 * np.abs(ref))
    assert not (err > 0).any(), np.abs(got - ref).max()
    assert ref.std() > 0.05  # the mesh is in the frame, not only sky


def test_cli_gltf_scene_on_cpu(tmp_path):
    from rt_tpu_torch import cli

    path = small_glb(tmp_path)
    out = tmp_path / "g.png"
    assert cli.main(["--scene", f"gltf:{path}", "--camera", "widecam", "--size", "16x9",
                     "--spp", "1", "--max-depth", "4", "--device", "cpu", "--out", str(out)]) == 0
    img = png_io.decode_png(out.read_bytes())
    assert img.shape == (9, 16, 3) and img.std() > 0
