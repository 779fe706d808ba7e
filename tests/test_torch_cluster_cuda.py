"""K4/K4b and K5, the clustered kernels, against their plain versions.

The ``cuda`` tests run only where a card is present: built without fused
multiply-adds, each kernel must agree with its plain version bit for bit
(winners and t for K4/K4b, the image for K5), on the test scenes, on the
tie scene and the far grazing rays of test_torch_walk_order.py (whose
widened sphere boxes must give the brute-force hits), on the prefix scenes of
torch_cluster_cases.py, whose clusters hold 1 to 128 live slots (so the
last lane that loads a cluster holds live and dead slots, or none loads),
on its row scenes, where the kernels' near-to-far visit enters other
clusters than the plain version's ascending one (also with more than 64
supers, and with two clusters whose slots tie in t and primitive id), and
on its face scene, whose hits lie on the entry faces of flat boxes.
This file imports nothing of the JAX package, so that it also runs on a machine that has PyTorch for CUDA but not the JAX
package's dependencies; the comparisons with the JAX package are in
test_torch_cluster.py and test_torch_clustered.py.
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch import cluster_ops, megakernel
from rt_tpu_torch import scene as tscene
from rt_tpu_torch.camera import make_camera
from rt_tpu_torch.config import RenderConfig
import torch_cluster_cases as cases  # tests/torch_cluster_cases.py
from test_torch_walk_order import (FAR_BANDS, ROW_SUPERS, _far_field, _reversed_ids,
                                   tie_grid_scene, tie_rays, tie_scene, with_ids)

torch.set_num_threads(2)

T_MIN, T_MAX = 1e-3, 1e9
W, H = 32, 24
_tables = cluster_ops.cluster_tables


def _rays(n, seed, device="cpu"):
    return torch.from_numpy(cases.random_rays(np.random.default_rng(seed), n=n, extent=4.0)).to(device)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def test_wrappers_check_shapes():
    cl = cases.tri_cloud(tscene).build().clusters
    rays, tables = _rays(512, 1), _tables(cl)
    with pytest.raises(ValueError, match="cluster_worklist_nearest"):
        cluster_ops.cluster_worklist_nearest(rays[:, :300], *tables, cl.n_sph_slots, T_MIN, T_MAX)
    with pytest.raises(ValueError, match="cluster_nearest"):
        cluster_ops.cluster_nearest(rays[:6], *tables, cl.n_sph_slots, T_MIN, T_MAX)
    bad = list(tables)
    bad[5] = bad[5][:32]  # clusters not a multiple of 64
    with pytest.raises(ValueError, match="cluster_nearest"):
        cluster_ops.cluster_nearest(rays, *bad, cl.n_sph_slots, T_MIN, T_MAX)
    bad = list(tables)
    bad[6] = bad[6][:, :-128]  # slots do not match the clusters
    with pytest.raises(ValueError, match="cluster_nearest"):
        cluster_ops.cluster_nearest(rays, *bad, cl.n_sph_slots, T_MIN, T_MAX)
    for prim in (tables[7][:-1], tables[7].to(torch.int64)):  # not an int32 id a slot
        bad = list(tables)
        bad[7] = prim
        with pytest.raises(ValueError, match="cluster_nearest"):
            cluster_ops.cluster_nearest(rays, *bad, cl.n_sph_slots, T_MIN, T_MAX)


def test_plain_walk_does_not_depend_on_its_chunks(monkeypatch):
    """The plain version walks the rays in chunks; each ray's result is
    its own."""
    cl = cases.image_tris(tscene).build().clusters
    rays = _rays(1024, 2)
    whole = cluster_ops.cluster_nearest(rays, *_tables(cl), cl.n_sph_slots, T_MIN, T_MAX)
    monkeypatch.setattr(cluster_ops, "_PLAIN_CHUNK", 100)
    chunked = cluster_ops.cluster_nearest(rays, *_tables(cl), cl.n_sph_slots, T_MIN, T_MAX)
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))
    assert (whole[1] >= 0).sum() > 50


@pytest.mark.cuda
def test_cuda_cluster_kernel_matches_plain_version():
    """K4 on the whole tables and per page (the JAX package's pages of 64
    clusters, with their slot bases) and K4b on the whole tables, culling
    on and off: winners and t bit for bit."""
    _cuda()
    cl = cases.tri_cloud(tscene, n_tris=9000).build().clusters.to("cuda")
    pages = cases.cluster_pages(cl, 64)
    assert len(pages) > 2
    rays = _rays(4096, 3, "cuda")
    for cull in (True, False):
        ref = cluster_ops.cluster_nearest_plain(rays, *_tables(cl), cl.n_sph_slots, T_MIN, T_MAX,
                                                cull)
        before = dict(cluster_ops.LAUNCHES)
        got = cluster_ops.cluster_nearest(rays, *_tables(cl), cl.n_sph_slots, T_MIN, T_MAX, cull)
        whole = cluster_ops.cluster_worklist_nearest(rays, *_tables(cl), cl.n_sph_slots, T_MIN,
                                                     T_MAX, cull)
        assert cluster_ops.LAUNCHES["cluster_nearest"] == before["cluster_nearest"] + 1
        assert (cluster_ops.LAUNCHES["cluster_worklist_nearest"]
                == before["cluster_worklist_nearest"] + 1)
        for a, b in zip((*got, *whole), (*ref, *ref)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for tables, s_base, t_base in pages:
            args = (rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, cull, s_base, t_base)
            got = cluster_ops.cluster_worklist_nearest(*args)
            for a, b in zip(got, cluster_ops.cluster_nearest_plain(*args)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert (ref[1] >= 0).sum() > 100


@pytest.mark.cuda
def test_cuda_clustered_megakernel_matches_plain_version():
    """K5 against its plain version on the card: the image bit for bit on
    the triangle cloud, the image-textured triangles and the tie scene, a
    full frame and an offset half frame."""
    _cuda()
    cam = make_camera((6, 0, 2), (0, 0, 1), (0, 0, 1), focus_distance=6.0, defocus_angle=0.0,
                      image_width=W, image_height=H, vertical_fov=30.0)
    down = make_camera((0.5, -3.5, 5.0), (0.0, 0.0, 0.5), (0, 0, 1), focus_distance=6.0,
                       defocus_angle=0.0, image_width=W, image_height=H, vertical_fov=60.0)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=6)
    scenes = ((lambda: cases.tri_cloud(tscene).build(), cam),
              (lambda: cases.image_tris(tscene).build(), cam), (tie_scene, down))
    for build, camera in scenes:
        scene = build().to("cuda")
        for off, base, n in ((0, 0, None), (3, W * H // 2, W * H // 2)):
            ref = megakernel.render_megakernel_plain(scene, camera, cfg, 2, off, 0,
                                                     pixel_base=base, n_pixels=n)
            before = megakernel.LAUNCHES_CLUSTERED
            got = megakernel.render_megakernel(scene, camera, cfg, 2, off, 0, pixel_base=base,
                                               n_pixels=n)
            assert megakernel.LAUNCHES_CLUSTERED == before + 1
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
            assert float(ref.mean()) > 0.01


@pytest.mark.cuda
def test_cuda_cluster_kernel_ties_bit_for_bit():
    """K4 and K4b on the tie scene's rays, culling on and off: the first
    copy of every tie wins, as in the plain version."""
    _cuda()
    cl = tie_scene().clusters.to("cuda")
    rays = tie_rays().to("cuda")
    for cull in (True, False):
        ref = cluster_ops.cluster_nearest_plain(rays, *_tables(cl), cl.n_sph_slots, T_MIN, T_MAX,
                                                cull)
        for fn in (cluster_ops.cluster_nearest, cluster_ops.cluster_worklist_nearest):
            got = fn(rays, *_tables(cl), cl.n_sph_slots, T_MIN, T_MAX, cull)
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert (ref[1] >= 0).sum() > 500


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ties", "grid"])
def test_cuda_cluster_kernels_break_ties_by_primitive_id(name):
    """K4, K4b and K5 with slot primitive ids: on the tie scene with ids
    that reverse the slot order and on the grid scene with its own ids,
    winners, t and the image bit for bit with the plain versions."""
    _cuda()
    scene = (tie_scene() if name == "ties" else tie_grid_scene()).to("cuda")
    cl = scene.clusters
    tables = _tables(cl)
    if name == "ties":
        tables = with_ids(tables, *(p.to("cuda") for p in _reversed_ids(cl)))
    rays = tie_rays().to("cuda")
    for cull in (True, False):
        ref = cluster_ops.cluster_nearest_plain(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, cull)
        for fn in (cluster_ops.cluster_nearest, cluster_ops.cluster_worklist_nearest):
            got = fn(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, cull)
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    if name == "grid":
        down = make_camera((0.5, -3.5, 5.0), (0.0, 0.0, 0.5), (0, 0, 1), focus_distance=6.0,
                           defocus_angle=0.0, image_width=W, image_height=H, vertical_fov=60.0)
        cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=6)
        ref = megakernel.render_megakernel_plain(scene, down, cfg, 2, 0, 0)
        got = megakernel.render_megakernel(scene, down, cfg, 2, 0, 0)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("band", list(FAR_BANDS))
def test_cuda_cluster_kernels_widen_sphere_boxes(band):
    """K4 and K4b on the far grazing rays of test_torch_walk_order.py, out
    to the largest distance a configuration meets: winners and t bit for
    bit with the plain walk, and t equal to the brute-force search's (the
    sphere boxes widened on the card as in the plain version)."""
    _cuda()
    scene, cfg, rays6 = _far_field(band)
    scene = scene.to("cuda")
    cl = scene.clusters
    rays = torch.cat([rays6, torch.zeros((2, rays6.shape[1]))]).to("cuda")
    ref = cluster_ops.cluster_nearest_plain(rays, *_tables(cl), cl.n_sph_slots, cfg.t_min,
                                            cfg.t_max)
    for fn in (cluster_ops.cluster_nearest, cluster_ops.cluster_worklist_nearest):
        got = fn(rays, *_tables(cl), cl.n_sph_slots, cfg.t_min, cfg.t_max)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    t_flat, _ = megakernel.flat_search(scene, cfg, rays[:6])
    torch.testing.assert_close(ref[0], t_flat, rtol=0, atol=0)
    assert (ref[1] >= 0).sum() > 100


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(cases.PREFIX_CASES))
def test_cuda_cluster_kernels_on_partly_filled_clusters(case):
    """K4 (whole tables and its one page), K4b and K5 on a prefix scene:
    clusters of live counts 1 to 128, one with none, and a last live slot
    that ties an earlier one.  Winners, t and the image bit for bit."""
    _cuda()
    scene, _ = cases.prefix_scene(case)
    scene = scene.to("cuda")
    cl = scene.clusters
    rays = cases.prefix_rays(cl).to("cuda")
    for cull in (True, False):
        ref = cluster_ops.cluster_nearest_plain(rays, *_tables(cl), cl.n_sph_slots, T_MIN, T_MAX,
                                                cull)
        for fn in (cluster_ops.cluster_nearest, cluster_ops.cluster_worklist_nearest):
            got = fn(rays, *_tables(cl), cl.n_sph_slots, T_MIN, T_MAX, cull)
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        [(tables, s_base, t_base)] = cases.cluster_pages(cl)
        got = cluster_ops.cluster_worklist_nearest(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX,
                                                   cull, s_base, t_base)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert (ref[1] >= 0).sum() > rays.shape[1] // 4
    above = make_camera((3.0, -6.0, 6.0), (3.0, 0.0, 0.5), (0, 0, 1), focus_distance=8.0,
                        defocus_angle=0.0, image_width=W, image_height=H, vertical_fov=60.0)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=6)
    ref = megakernel.render_megakernel_plain(scene, above, cfg, 2, 0, 0)
    got = megakernel.render_megakernel(scene, above, cfg, 2, 0, 0)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert float(ref.mean()) > 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rows", "row_supers"])
def test_cuda_cluster_kernels_on_the_row_scene(layout):
    """K4, K4b and K5 on a row scene, whose rays meet clusters in falling
    index (the near-to-far walk enters the nearest and stops, the plain
    walk enters them all): winners, t and the image bit for bit with the
    plain versions, culling on and off; on the plain row scene also with
    the nearest wall repeated at a lower and a higher cluster with equal
    primitive ids (the lower slot wins)."""
    _cuda()
    scene = (cases.row_scene() if layout == "rows" else cases.row_scene(**ROW_SUPERS)).to("cuda")
    cl = scene.clusters
    rays = cases.row_rays().to("cuda")
    variants = [_tables(cl)]
    if layout == "rows":
        variants += [cases.copy_nearest_wall(_tables(cl), copy) for copy in (20, 48)]
    for tables in variants:
        for cull in (True, False):
            ref = cluster_ops.cluster_nearest_plain(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX,
                                                    cull)
            for fn in (cluster_ops.cluster_nearest, cluster_ops.cluster_worklist_nearest):
                got = fn(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, cull)
                for a, b in zip(got, ref):
                    torch.testing.assert_close(a, b, rtol=0, atol=0)
            assert (ref[1] >= 0).sum() > rays.shape[1] // 4
    along = make_camera((cases.ROW_FAR, 0.5, 1.2), (0.0, 0.8, 1.0), (0, 0, 1), focus_distance=8.0,
                        defocus_angle=0.0, image_width=W, image_height=H, vertical_fov=40.0)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=6)
    ref = megakernel.render_megakernel_plain(scene, along, cfg, 2, 0, 0)
    got = megakernel.render_megakernel(scene, along, cfg, 2, 0, 0)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert float(ref.mean()) > 0.01


@pytest.mark.cuda
def test_cuda_cluster_kernels_on_the_face_scene():
    """K4, K4b and K5 on the face scene, whose nearest hits lie on the entry
    face of two flat cluster boxes and go to the lower ids (FACE_LOW),
    though the near-to-far walk enters the copy first: winners, t and the
    image bit for bit with the plain versions, culling on and off."""
    _cuda()
    scene = cases.face_scene().to("cuda")
    cl = scene.clusters
    rays = cases.face_rays().to("cuda")
    tables = _tables(cl)
    low = cl.n_sph_slots + cases.FACE_LOW * 128
    for cull in (True, False):
        ref = cluster_ops.cluster_nearest_plain(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, cull)
        assert bool(((ref[1] >= low) & (ref[1] < low + 128)).all())
        for fn in (cluster_ops.cluster_nearest, cluster_ops.cluster_worklist_nearest):
            got = fn(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, cull)
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    facing = make_camera((12.0, 0.3, 0.2), (0.0, 0.0, 0.0), (0, 0, 1), focus_distance=12.0,
                         defocus_angle=0.0, image_width=W, image_height=H, vertical_fov=12.0)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=6)
    ref = megakernel.render_megakernel_plain(scene, facing, cfg, 2, 0, 0)
    got = megakernel.render_megakernel(scene, facing, cfg, 2, 0, 0)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert float(ref.mean()) > 0.01
