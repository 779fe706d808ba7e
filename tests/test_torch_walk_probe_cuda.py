"""The BVH walk kernel (csrc/bvh_walk.cu) and K6's kernels
(csrc/micro_probe.cu) against their plain PyTorch versions on the card,
and repeats of pixel_grad on the config-3 blob (through the walk kernel)
bit-identical to a first call.

This file imports nothing of JAX, so it also runs where the JAX package
does not import.  Every test is ``cuda``-marked and skips without a card.
Tolerances: the walk bit for bit (t and primitive ids), as the plain walk
does the same arithmetic in the same order; reduce and gather bit for bit
in every mode, at 256 visits and at the probe's 1,024; scatter (f32 sums
in another order than the plain version's matrix product) each scr
element within 1e-5 of max|scr|, the plane within 1e-5 of the sum of the
|scr| terms it adds up, and bit for bit equal to the sequential model of
tests/torch_micro_cases.py (the loop over every destination per column),
on the probe's destinations and on destinations repeated across k and s.
Serial CPU time of this file: ~3 s (every test skips there).
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch import micro_probe as mp
from rt_tpu_torch import scenes as tscenes
from rt_tpu_torch.bvh import traverse
from rt_tpu_torch.config import CompatConfig
from rt_tpu_torch.scene import SceneBuilder
from torch_micro_cases import repeated_dst, scatter_sequential

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ (csrc/bvh_walk.cu, "
                    "csrc/micro_probe.cu)")


def _spheres():
    rs = np.random.default_rng(7)
    b = SceneBuilder()
    m = b.lambertian_rgb(0.5, 0.5, 0.5)
    for _ in range(300):
        b.add_sphere(rs.uniform(-8, 8, 3), rs.uniform(0.2, 1.0), m)
    return b.build(use_bvh=True), 12.0


def _triangles():
    rs = np.random.default_rng(8)
    b = SceneBuilder()
    m = b.lambertian_rgb(0.5, 0.5, 0.5)
    for _ in range(200):
        base = rs.uniform(-5, 5, 3)
        b.add_triangle(base, base + rs.normal(size=3), base + rs.normal(size=3), m)
    b.add_sphere((0.0, 0.0, 0.0), 1.5, m)
    return b.build(use_bvh=True), 8.0


def _mesh(tmp_path):
    from tools.gen_fixtures import make_obj_mesh

    path = str(tmp_path / "blob.obj")
    make_obj_mesh(path, res=24)
    return tscenes.mesh_with_area_light(path), 3.0


@pytest.mark.parametrize("name", ["spheres", "triangles", "mesh"])
def test_cuda_walk_kernel_matches_plain_walk(name, tmp_path):
    ts, extent = {"spheres": _spheres, "triangles": _triangles,
                  "mesh": lambda: _mesh(tmp_path)}[name]()
    assert ts.bvh is not None
    ts = ts.to("cuda")
    rs = np.random.default_rng(6)
    org = torch.from_numpy(rs.uniform(-extent, extent, (4096, 3)).astype(np.float32)).cuda()
    dirn = torch.from_numpy(rs.normal(size=(4096, 3)).astype(np.float32)).cuda()
    for t_max, cull in ((3e38, True), (3e38, False), (2.5, True)):
        compat = CompatConfig(triangle_backface_cull=cull)
        before = traverse.LAUNCHES["bvh_walk"]
        got = traverse.bvh_walk(ts, org, dirn, 1e-3, t_max, compat)
        want = traverse.bvh_walk_plain(ts, org, dirn, 1e-3, t_max, compat)
        assert traverse.LAUNCHES["bvh_walk"] == before + 1
        assert int((want[1] >= 0).sum()) > (100 if t_max > 1e30 else 0)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cuda_mesh_pixel_grad_repeats_bit_identical(tmp_path, repeats=10):
    """pixel_grad on the config-3 blob (tools/gen_fixtures' default mesh and
    the area light, 99,908 triangles) at 800x450, every pixel at 1 spp,
    diff_max_depth 6: every repeat equal to the first, bit for bit, in the
    loss and every leaf.  Prints the leaves of each repeat that differ."""
    from tools.gen_fixtures import make_obj_mesh

    from rt_tpu_torch import grad, rng
    from rt_tpu_torch.camera import make_camera
    from rt_tpu_torch.config import RenderConfig

    path = str(tmp_path / "blob.obj")
    make_obj_mesh(path)
    scene = tscenes.mesh_with_area_light(path).to("cuda")
    w, h = 800, 450
    camera = make_camera((5.5, -5.5, 2.2), (0.0, 0.0, 1.0), (0.0, 0.0, 1.0),
                         focus_distance=float((2 * 5.5 * 5.5 + 1.2 ** 2) ** 0.5),
                         defocus_angle=0.0, image_width=w, image_height=h, vertical_fov=32.0)
    cfg = RenderConfig(width=w, height=h, diff_max_depth=6)
    args = (scene, camera, cfg, torch.arange(w * h, device="cuda"),
            torch.zeros((w * h, 3), device="cuda"), rng.key(0))
    loss, g = grad.pixel_grad(*args)
    assert bool(torch.isfinite(loss)) and loss.item() > 0
    differ = {}
    for rep in range(1, repeats + 1):
        loss_r, g_r = grad.pixel_grad(*args)
        leaves = [k for k, a, b in zip(g._fields, g, g_r) if not torch.equal(a, b)]
        leaves += [] if torch.equal(loss, loss_r) else ["loss"]
        if leaves:
            differ[rep] = leaves
    print(f"pixel_grad on the blob: {len(differ)} of {repeats} repeats differ from the first "
          f"{differ}")
    assert not differ


@pytest.mark.parametrize("mode", mp.MODES)
def test_cuda_micro_kernels_match_plain_versions(mode):
    data = mp.inputs("all", "cuda")
    for reps in (1, 3):
        r = data["reduce"]
        got = mp.reduce(r["rid"], r["key"], reps, 4096)
        want = mp.reduce_plain(r["rid"], r["key"], reps, 4096)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        g = data["gather"]
        for nv in (256, mp.NV):
            args = (g["rays_t"], g["slots"], g["item"], g["vcl"], reps, nv)
            got, want = mp.gather(*args, mode=mode), mp.gather_plain(*args, mode=mode)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        s = data["scatter"]
        (out, scr), (p_out, p_scr) = (mp.scatter(s["vals"], s["dst"], reps, 6),
                                      mp.scatter_plain(s["vals"], s["dst"], reps, 6))
        rows = p_scr[0, :1024].abs().reshape(8, 128).sum(dim=1)
        terms = sum(float(rows[rr & 7]) for rr in range(reps))
        assert float((scr - p_scr).abs().max()) <= 1e-5 * float(p_scr.abs().max())
        assert float((out - p_out).abs().max()) <= 1e-5 * terms
        for dst, n_chunks in ((s["dst"], 6), (repeated_dst(4, 3).cuda(), 18)):
            got = mp.scatter(s["vals"], dst, reps, n_chunks)
            want = scatter_sequential(s["vals"].cpu(), dst.cpu(), reps, n_chunks)
            assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])
