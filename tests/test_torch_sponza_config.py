"""The benchmark's configuration ``sponza_atrium`` (cell ``atrium-frames``,
the upstream's ``sponza()`` on a procedural stand-in for the Crytek Sponza
atrium), cut to a CPU test's size by its generator's ``tiny``: the same 25
glTF primitives and materials, coarse, with 32x32 textures.

The program's scene is built as a benchmark run builds it (the glb written
once under ``build/rtbench/``, then the generator's program side:
``scenes.sponza_scene`` over the glTF loader) and rendered through K5's
plain path; the plain reference (``rtbench.reference``, which imports
nothing of the port) recomputes seeded pixels from the raw description.
Also: the program's tables against the description replayed on a
``SceneBuilder``, and ``scene.ATLAS`` after the build.  ``sponza_scene``'s
spans, counters, CLI and the wrappers' atlas guard are checked in
``test_torch_sponza_scene.py``.
"""

import pytest
import torch

from rt_tpu_torch import megakernel, scenes
from rt_tpu_torch import scene as scene_mod
from rt_tpu_torch.io import gltf_loader
from rtbench import check, drivers, harness

torch.set_num_threads(2)

CELL = "atrium-frames"
W, H = 16, 12
SEEDS = [2**31 + 4242, 11]
TEX = 32  # the tiny cut's texture side
N_PRIMS = 25


@pytest.fixture(scope="module")
def tiny():
    """(config, the program's scene, camera, RenderConfig, and
    ``gltf_loader.COUNTS``, ``scene.ATLAS`` and ``scenes.COUNTS`` after the
    build) of the cell's configuration cut to the generator's ``tiny`` scene
    and a 16x12 frame, built as a benchmark run builds it."""
    spec = harness.load_cell(CELL)["config_spec"]
    inputs = harness.load_generator(spec["scene"]["generator"])
    config = dict(spec, width=W, height=H, scene=inputs.tiny(spec["scene"]))
    drivers.ensure_inputs(config)
    desc = check.describe(config)
    gltf_loader.COUNTS.update(dict.fromkeys(gltf_loader.COUNTS, 0))
    scene, camera, cfg = drivers.build_scene(config, desc, {})
    return (config, scene, camera, cfg, dict(gltf_loader.COUNTS), dict(scene_mod.ATLAS),
            dict(scenes.COUNTS))


@pytest.mark.parametrize("seed,spp", [(SEEDS[0], 2), (SEEDS[1], 2), (SEEDS[0], 8), (SEEDS[1], 8)])
def test_tiny_sponza_agrees_with_the_reference(tiny, seed, spp):
    config, scene, camera, cfg = tiny[:4]
    assert scene.num_spheres == 0 and 3_000 < scene.num_triangles < 10_000
    assert scene.clusters is not None and scene.bvh is not None
    assert megakernel.eligible_clustered(scene, cfg)
    img = megakernel.render_megakernel_plain(scene, camera, cfg, spp, 0, seed)
    ref = check.Reference(config, "cpu")
    pix = check.sample_pixels(seed, ref.n_pixels, 48, 0)
    nums = check.image_numbers(img.numpy()[pix], ref.frame_pixels(pix, spp, seed))
    limits = harness.load_cell(CELL)["check_spec"]["limits"]
    assert all(nums[k] <= v for k, v in limits.items()), nums


def test_program_tables_equal_the_replayed_description(tiny):
    config, scene = tiny[:2]
    desc = check.describe(config)
    assert len(desc["triangles"]["material"]) == scene.num_triangles
    replayed = drivers.replay(desc)
    built = dict(scene.named_buffers())
    assert sorted(dict(replayed.named_buffers())) == sorted(built)
    for name, buf in replayed.named_buffers():
        assert torch.equal(buf, built[name]), name
    assert bool(scene.has_image_textures)


def test_sponza_counts_and_atlas(tiny):
    """Every primitive its own material and image; ``scene.ATLAS`` holds the
    atlas the build packed."""
    scene, counts, atlas, composed = tiny[1], tiny[4], tiny[5], tiny[6]
    assert counts == {"primitives": N_PRIMS, "materials": N_PRIMS, "images": N_PRIMS,
                      "texels": N_PRIMS * TEX * TEX}
    assert atlas == {"textures": N_PRIMS, "height": N_PRIMS * TEX, "width": TEX,
                     "bytes": N_PRIMS * TEX * TEX * 3 * 4}
    assert tuple(scene.atlas.shape) == (atlas["height"], atlas["width"], 3)
    assert composed == {"lattice_cells": 0, "spheres": 0, "mesh_triangles": scene.num_triangles}


@pytest.mark.cuda
def test_cuda_k5_matches_plain_on_the_atrium(tiny):
    """K5 on the card against its plain version run on the card, on the tiny
    atrium: the same image bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    config, camera, cfg = tiny[0], tiny[2], tiny[3]
    card, _, _ = drivers.build_scene(config, check.describe(config), {})
    card.to(torch.device("cuda"))
    got = megakernel.render_megakernel(card, camera, cfg, 4, 0, SEEDS[0])
    want = megakernel.render_megakernel_plain(card, camera, cfg, 4, 0, SEEDS[0])
    assert torch.equal(got, want) and float(want.cpu().std()) > 0.05
