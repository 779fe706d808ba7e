"""The upstream's default scene on the port (main.rs:23-62): the benchmark's
configuration ``main_default_scene`` (cell ``field-frames``), cut to a CPU
test's size.

The program's scene is built as a benchmark run builds it (the glb written
once under ``build/rtbench/``, then the generator's program side:
``scenes.default_scene`` over the glTF loader), at a lattice that takes the
bulk draw, and rendered through K5's plain path; the plain reference
(``rtbench.reference``, which imports nothing of the port) recomputes
seeded pixels from the raw description.  Also: the program's tables against
the description replayed on a ``SceneBuilder``, ``cover_scene``'s tables
pinned from before its lattice became ``add_cover_lattice``, the spans and
``scenes.COUNTS`` of a composition, and the CLI's ``default:PATH``.
"""

import hashlib

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rt_tpu_torch import cli, megakernel, profiling, scenes
from rtbench import check, drivers, harness

torch.set_num_threads(2)

CELL = "field-frames"
W, H = 16, 12
SEEDS = [2**31 + 12345, 7]
# cover_scene's tables and sizes, hashed by ``_digest`` from the function as
# it stood before its lattice moved into ``add_cover_lattice``: 11 x 11
# (the loop's draw, 447 spheres) and 51 x 51 (the bulk draw, 10,363).
COVER_DIGESTS = {
    11: "4f0534e097233befb2cda82e8f4d64c6df1778a698418bd24eee83afe34945bf",
    51: "5236d0bc8714eee081d24089ac5e1cb4f11c4ef85fc0d4f0e0dc52d063f274e6",
}


def _digest(scene) -> str:
    """sha256 of every buffer of a scene (by name: dtype, shape, bytes) and
    its sizes, but the cluster slots' primitive ids, which the scene builder
    gained after the pin."""
    h = hashlib.sha256()
    for name, buf in sorted(scene.named_buffers()):
        if buf is None or name in ("clusters.sph_prim", "clusters.tri_prim"):
            continue
        a = buf.detach().cpu().contiguous()
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(tuple(a.shape)).encode())
        h.update(a.numpy().tobytes())
    slots = scene.clusters.n_sph_slots if scene.clusters is not None else None
    h.update(repr((scene.num_spheres, scene.num_triangles, slots)).encode())
    return h.hexdigest()


@pytest.fixture(scope="module")
def tiny():
    """(config, its reference-side generator, the program's scene, camera,
    RenderConfig, the scene's CPU profile and ``scenes.COUNTS`` after the
    build) of the cell's configuration cut to the generator's ``tiny``
    scene and a 16x12 frame, built as a benchmark run builds it, under a
    profiler."""
    spec = harness.load_cell(CELL)["config_spec"]
    inputs = harness.load_generator(spec["scene"]["generator"])
    config = dict(spec, width=W, height=H, scene=inputs.tiny(spec["scene"]))
    drivers.ensure_inputs(config)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scene, camera, cfg = drivers.build_scene(config, check.describe(config), {})
    return config, inputs, scene, camera, cfg, prof, dict(scenes.COUNTS)


@pytest.mark.parametrize("seed,spp", [(SEEDS[0], 2), (SEEDS[1], 2), (SEEDS[0], 8)])
def test_tiny_default_scene_agrees_with_the_reference(tiny, seed, spp):
    config, _, scene, camera, cfg = tiny[:5]
    assert scene.num_spheres > 10_000 and scene.num_triangles == 2 + 792
    assert scene.clusters is not None and scene.bvh is not None
    assert megakernel.eligible_clustered(scene, cfg)
    img = megakernel.render_megakernel_plain(scene, camera, cfg, spp, 0, seed)
    ref = check.Reference(config, "cpu")
    pix = check.sample_pixels(seed, ref.n_pixels, 48, 0)
    nums = check.image_numbers(img.numpy()[pix], ref.frame_pixels(pix, spp, seed))
    limits = harness.load_cell(CELL)["check_spec"]["limits"]
    assert all(nums[k] <= v for k, v in limits.items()), nums


def test_program_tables_equal_the_replayed_description(tiny):
    config, _, scene = tiny[:3]
    desc = check.describe(config)
    assert len(desc["spheres"]["radius"]) == scene.num_spheres
    replayed = dict(drivers.replay(desc).named_buffers())
    built = dict(scene.named_buffers())
    assert sorted(replayed) == sorted(built)
    for name, buf in built.items():
        assert torch.equal(buf, replayed[name]), name
    assert scene.clusters.n_sph_slots == drivers.replay(desc).clusters.n_sph_slots


@pytest.mark.parametrize("grid", sorted(COVER_DIGESTS))
def test_cover_scene_tables_are_pinned(grid):
    scene = scenes.cover_scene(grid, grid, scenes.cam1(), z=-0.2, seed=0)
    assert _digest(scene) == COVER_DIGESTS[grid]
    assert scenes.COUNTS == {"lattice_cells": 4 * grid * grid, "spheres": scene.num_spheres,
                             "mesh_triangles": 0}


def test_default_scene_spans_and_counts(tiny):
    scene, prof, counts = tiny[2], tiny[5], tiny[6]
    assert counts == {"lattice_cells": 4 * 51 * 51, "spheres": scene.num_spheres,
                      "mesh_triangles": 792}
    spans = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU and ev.name().startswith("rt."):
            spans.setdefault(ev.name(), (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    s, e = spans["rt.scenes.default"]
    inner = [spans[k] for k in ("rt.scenes.lattice", "rt.gltf.load", "rt.scene.build")]
    assert all(s <= a and b <= e for a, b in inner)
    assert inner[0][1] <= inner[1][0] and inner[1][1] <= inner[2][0]


@pytest.mark.parametrize("grid", [11, 51])
def test_lattice_span_args(monkeypatch, grid):
    """``rt.scenes.lattice`` names the grid's cells and the small spheres it
    kept, in the loop's draw and the bulk draw."""
    calls = []
    real = profiling.span
    monkeypatch.setattr(profiling, "span", lambda name, args=None: calls.append((name, args))
                        or real(name, args))
    scene = scenes.cover_scene(grid, grid, scenes.cam1(), z=-0.2, seed=0)
    assert ("scenes.lattice", f"cells={4 * grid * grid} spheres={scene.num_spheres - 3}") in calls


def test_a_scene_the_program_side_does_not_build_is_refused(tiny):
    """The scene function fixes the ground and the lattice's height: a
    configuration that states another stops the build."""
    config = tiny[0]
    sc = config["scene"]
    changed = dict(config, scene=dict(sc, ground=dict(sc["ground"], scale=0.75)))
    program_side = harness.load_generator(sc["generator"], "scenes")
    with pytest.raises(ValueError, match="ground.scale"):
        program_side.build(changed, None, drivers.BUILD_DIR)


def test_cli_default_scene_renders(tiny, tmp_path, monkeypatch):
    """``--scene default:PATH`` composes the scene through
    ``scenes.default_scene`` (here at a 51 x 51 lattice; the CLI's is the
    upstream's 300 x 300) and renders it through ``render_image``."""
    config = tiny[0]
    glb = harness.load_generator(config["scene"]["generator"]).glb_path(config["scene"],
                                                                        drivers.BUILD_DIR)
    got = {}
    real = scenes.default_scene

    def small(camera, gltf_path, grid=300, **kw):
        got.update(grid=grid, path=gltf_path, **kw)
        return real(camera, gltf_path, grid=51, **kw)

    monkeypatch.setattr(scenes, "default_scene", small)
    out = tmp_path / "d.png"
    assert cli.main(["--scene", f"default:{glb}", "--size", "8x6", "--spp", "1", "--max-depth",
                     "2", "--seed", "3", "--device", "cpu", "--out", str(out)]) == 0
    assert got == {"grid": 300, "path": glb, "seed": 3} and out.stat().st_size > 0
    assert scenes.COUNTS["mesh_triangles"] == 792
    assert scenes.COUNTS["lattice_cells"] == 4 * 51 * 51
    assert scenes.COUNTS["spheres"] == 10_363
