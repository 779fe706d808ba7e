"""The upstream's Sponza scene on the port (``sponza()``, scenes.rs:443-458):
``scenes.sponza_scene`` and the CLI's ``sponza:PATH`` over a multi-part
textured glb (``fixtures.make_glb_armor``: each part its own primitive,
material and 64x64 PNG; at seed 1 two parts are metal by
``metallicFactor`` and two are not).

Checked: the scene's tables against the glTF added to a ``SceneBuilder``
under the corrected material mapping and the live sky, the spans
``rt.scenes.sponza`` ⊃ ``rt.gltf.load`` ⊃ ``rt.gltf.images`` and
``rt.scene.build`` ⊃ ``rt.scene.atlas`` with their args,
``gltf_loader.COUNTS`` and ``scenes.COUNTS``, an image shared by two
materials decoded once, the CLI's render, and the wrappers' refusal of an
atlas that their int32 texel index cannot address.
"""

import base64
import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rt_tpu_torch import cli, megakernel, profiling, scenes
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.fixtures import make_glb_armor
from rt_tpu_torch.io import gltf_loader, png_io
from rt_tpu_torch.io.gltf_loader import add_gltf_to_scene
from rt_tpu_torch.scene import MAT_LAMBERTIAN, MAT_METAL, SceneBuilder
from rt_tpu_torch.sky import SkyParams

torch.set_num_threads(2)

N_PARTS = 4
RES = 24  # 1,104 triangles a part
TEX = 64  # make_glb_armor's texture side


def _reset(counts: dict) -> None:
    counts.update(dict.fromkeys(counts, 0))


@pytest.fixture(scope="module")
def atrium(tmp_path_factory):
    """(the glb's path, the scene ``sponza_scene`` builds from it, the
    build's CPU profile, ``gltf_loader.COUNTS`` and ``scenes.COUNTS`` after
    it, a 16x12 camera and its RenderConfig)."""
    path = str(tmp_path_factory.mktemp("sponza") / "atrium.glb")
    make_glb_armor(path, res=RES, n_parts=N_PARTS, seed=1)
    _reset(gltf_loader.COUNTS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scene = scenes.sponza_scene(path)
    camera = scenes.widecam(16, 12)
    cfg = RenderConfig(width=16, height=12, samples_per_pixel=2, max_depth=8)
    return path, scene, prof, dict(gltf_loader.COUNTS), dict(scenes.COUNTS), camera, cfg


def _spans(prof) -> dict:
    spans = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU and ev.name().startswith("rt."):
            spans.setdefault(ev.name(), (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return spans


def test_sponza_scene_is_the_gltf_under_the_live_sky(atrium):
    """The glTF alone, its materials by the corrected mapping (metal from
    metallic 0.5 on, else lambertian), under ``SkyParams.hosek()``."""
    path, scene = atrium[:2]
    b = SceneBuilder()
    add_gltf_to_scene(b, path, compat_all_metal=False)
    want = b.build(sky=SkyParams.hosek())
    got = dict(scene.named_buffers())
    assert sorted(dict(want.named_buffers())) == sorted(got)
    for name, buf in want.named_buffers():
        assert torch.equal(buf, got[name]), name
    assert scene.num_spheres == 0 and scene.num_triangles == N_PARTS * RES * (RES - 1) * 2
    assert bool(scene.has_image_textures) and megakernel.eligible_clustered(scene, atrium[6])
    metallic = [m["pbrMetallicRoughness"]["metallicFactor"]
                for m in json.loads(_json_chunk(path))["materials"]]
    assert scene.mat_kind.tolist() == [MAT_METAL if m >= 0.5 else MAT_LAMBERTIAN
                                       for m in metallic]
    assert sorted(scene.mat_kind.tolist()) == [MAT_LAMBERTIAN] * 2 + [MAT_METAL] * 2


def _json_chunk(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[12:16], "little")
    return data[20 : 20 + n]


def test_sponza_spans_nest(atrium):
    """``rt.scenes.sponza`` holds the glTF's load (its images' decode inside)
    and then the build (its atlas inside)."""
    spans = _spans(atrium[2])
    s, e = spans["rt.scenes.sponza"]
    load, images = spans["rt.gltf.load"], spans["rt.gltf.images"]
    build, atlas = spans["rt.scene.build"], spans["rt.scene.atlas"]
    assert s <= load[0] and load[1] <= build[0] and build[1] <= e
    assert load[0] <= images[0] and images[1] <= load[1]
    assert build[0] <= atlas[0] and atlas[1] <= build[1]


def test_sponza_counts(atrium):
    scene, counts, composed = atrium[1], atrium[3], atrium[4]
    assert counts == {"primitives": N_PARTS, "materials": N_PARTS, "images": N_PARTS,
                      "texels": N_PARTS * TEX * TEX}
    assert tuple(scene.atlas.shape) == (N_PARTS * TEX, TEX, 3)
    assert composed == {"lattice_cells": 0, "spheres": 0, "mesh_triangles": scene.num_triangles}


def test_image_and_atlas_span_args(atrium, monkeypatch):
    """``rt.gltf.images`` names the images decoded, ``rt.scene.atlas`` the
    image textures handed in and their bytes."""
    calls = []
    real = profiling.span
    monkeypatch.setattr(profiling, "span", lambda name, args=None: calls.append((name, args))
                        or real(name, args))
    scenes.sponza_scene(atrium[0])
    assert ("gltf.images", f"images={N_PARTS}") in calls
    assert ("scene.atlas", f"textures={N_PARTS} bytes={N_PARTS * TEX * TEX * 12}") in calls
    assert ("scenes.sponza", None) in calls


def test_gltf_images_are_decoded_once_each(tmp_path):
    """Two primitives whose materials share one image share its decode:
    ``COUNTS`` counts two primitives and materials, one image and its
    texels, and both records hold the same array."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32).tobytes()
    png = png_io.encode_png(np.full((3, 4, 3), 200, np.uint8))
    uri = lambda kind, data: f"data:{kind};base64," + base64.b64encode(data).decode()
    doc = {"asset": {"version": "2.0"},
           "buffers": [{"byteLength": len(pos), "uri": uri("application/octet-stream", pos)}],
           "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(pos)}],
           "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"}],
           "images": [{"uri": uri("image/png", png)}], "textures": [{"source": 0}],
           "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                   "roughnessFactor": r}} for r in (0.2, 0.7)],
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "material": k}]}
                      for k in (0, 1)]}
    path = tmp_path / "shared.gltf"
    path.write_text(json.dumps(doc))
    _reset(gltf_loader.COUNTS)
    prims = gltf_loader.load_gltf(str(path))
    assert gltf_loader.COUNTS == {"primitives": 2, "materials": 2, "images": 1, "texels": 12}
    assert prims[0]["base_color_image"] is prims[1]["base_color_image"]
    assert prims[0]["base_color_image"].shape == (3, 4, 3)


def test_cli_sponza_renders(atrium, tmp_path, monkeypatch):
    """``--scene sponza:PATH`` composes the scene through
    ``scenes.sponza_scene`` and renders it through ``render_image`` on the
    clustered megakernel's path."""
    got = {}
    real = scenes.sponza_scene

    def spy(path):
        got["path"] = path
        got["scene"] = real(path)
        return got["scene"]

    monkeypatch.setattr(scenes, "sponza_scene", spy)
    out = tmp_path / "s.png"
    assert cli.main(["--scene", f"sponza:{atrium[0]}", "--camera", "widecam", "--size", "8x6",
                     "--spp", "1", "--max-depth", "2", "--seed", "3", "--device", "cpu",
                     "--out", str(out)]) == 0
    assert got["path"] == atrium[0] and out.stat().st_size > 0
    assert megakernel.eligible_clustered(got["scene"], atrium[6])
    assert scenes.COUNTS["mesh_triangles"] == atrium[1].num_triangles


@pytest.mark.parametrize("wrapper", ["_launch", "_launch_clustered"])
def test_wrappers_refuse_an_atlas_past_int32(atrium, wrapper, monkeypatch):
    """An atlas of 2^31 floats or more would wrap ``bounce()``'s int32 texel
    index: both wrappers refuse it, naming its size.  The atlas is a
    broadcast view, so nothing that large is allocated."""
    scene, camera, cfg = atrium[1], atrium[5], atrium[6]
    big = torch.zeros((1, 1, 3)).expand(2**31 // 3 // 1024 + 1, 1024, 3)
    assert big.numel() >= 2**31
    monkeypatch.setattr(scene, "atlas", big)
    with pytest.raises(ValueError, match=f"atlas of {big.numel()} floats"):
        getattr(megakernel, wrapper)(scene, camera, cfg, 1, 0, 0, 0, None)


def test_atlas_guard_edge():
    """The guard's edge: 2^31 - 1 floats pass it, 2^31 do not."""
    megakernel._check_atlas(torch.zeros((1,)).expand(2**31 - 1))
    with pytest.raises(ValueError):
        megakernel._check_atlas(torch.zeros((1,)).expand(2**31))


@pytest.mark.cuda
def test_cuda_k5_matches_plain_on_sponza_scene(atrium):
    """K5 on the card against its plain version run on the card, on
    ``sponza_scene``'s scene: the same image bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    path, camera, cfg = atrium[0], atrium[5], atrium[6]
    scene = scenes.sponza_scene(path).to(torch.device("cuda"))
    got = megakernel.render_megakernel(scene, camera, cfg, 4, 0, 2**31 + 4242)
    want = megakernel.render_megakernel_plain(scene, camera, cfg, 4, 0, 2**31 + 4242)
    assert torch.equal(got, want) and float(want.cpu().std()) > 0.05
