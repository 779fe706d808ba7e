"""Clustered scenes through the port's renderers on the CPU, against the
JAX package: the clustered megakernel (K5) and the clustered wavefront
(K4), each by its plain version, at 32x24 and max_depth 6.

References and tolerances:
- ``rt_tpu.wavefront._render_fast``, which on the CPU brute-forces
  clustered scenes over the per-primitive shade table: atol/rtol 1e-3, the
  megakernel parity tolerance.  The search differs (cluster walk and slot
  ids against brute force and primitive ids) but finds the same winners
  with the same t, and both sides draw from the same hash streams.
- The 2,100-sphere scene follows tests/test_megakernel_cluster.py:108-140:
  one-ulp differences on thousands of silhouettes decorrelate a few paths,
  so the image mean must agree within 2e-3 and at most 2% of the pixels
  may differ by more than 2e-3.
- The JAX clustered megakernel in interpret mode with its expansion sweep
  and lane binning off: tests/test_megakernel_cluster.py's ``_compare``
  tolerance (atol 2e-3, rtol 1e-3) with no outlier pixel (with expansion
  off every candidate set is exact).  Its scene has no checker texture and
  no metal fuzz: the TPU kernel's inline table quantizes fuzz to 12 bits,
  and the image's middle column sits on the checker's y = 0 cell boundary,
  where XLA's fused multiply-adds flip the parity of a hit point.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu import scene as jscene
from rt_tpu.camera import make_camera as j_make_camera
from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.megakernel import render_megakernel as j_render_megakernel
from rt_tpu.render import render_pixel_colors as j_render_pixel_colors
from rt_tpu.wavefront import _render_fast as j_render_fast
from rt_tpu_torch import cluster_ops, megakernel, rng, wavefront
from rt_tpu_torch import scene as tscene
from rt_tpu_torch.camera import make_camera
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.render import render_pixel_colors
import torch_cluster_cases as cases  # tests/torch_cluster_cases.py

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _jax_native_builder():
    """The JAX side's tables come from its native BVH builder, as the
    port's do from the port's copy."""
    assert cases.load_jax_native(), "the JAX package's native BVH builder did not load"

W, H = 32, 24
TOL = dict(atol=1e-3, rtol=1e-3)


def _camera(make):
    return make((6, 0, 2), (0, 0, 1), (0, 0, 1), focus_distance=6.0, defocus_angle=0.0,
                image_width=W, image_height=H, vertical_fov=30.0)


def _cfgs(spp=2, max_depth=6, **jax_only):
    return (JConfig(width=W, height=H, samples_per_pixel=spp, max_depth=max_depth, **jax_only),
            RenderConfig(width=W, height=H, samples_per_pixel=spp, max_depth=max_depth))


def _pair(factory, **kw):
    """(JAX scene, port scene) built by the two packages from one seed."""
    js, ts = factory(jscene, **kw).build(), factory(tscene, **kw).build()
    assert ts.clusters is not None
    return js, ts


def _fast_reference(js, jcfg, spp):
    return np.asarray(j_render_fast(js, _camera(j_make_camera), jnp.arange(W * H, dtype=jnp.int32),
                                    jcfg, spp, jnp.int32(0), jax.random.key(jcfg.seed)))


@pytest.mark.parametrize("name", ["tri_cloud_150", "image_tris_140"])
def test_megakernel_plain_matches_render_fast(name):
    """K5's plain version: every material, checkers, emissive triangles,
    and image-textured triangles through the slot-ordered table."""
    js, ts = _pair({"tri_cloud_150": cases.tri_cloud, "image_tris_140": cases.image_tris}[name])
    jcfg, tcfg = _cfgs()
    assert megakernel.eligible_clustered(ts, tcfg) and not megakernel.eligible(ts, tcfg)
    ref = _fast_reference(js, jcfg, 2)
    got = megakernel.render_megakernel(ts, _camera(make_camera), tcfg, 2, 0, tcfg.seed).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(ref).max() > 0.05


def test_megakernel_plain_sphere_heavy_scene():
    js, ts = _pair(cases.spheres_2100)
    jcfg, tcfg = _cfgs(spp=1, max_depth=4)
    ref = _fast_reference(js, jcfg, 1)
    got = megakernel.render_megakernel(ts, _camera(make_camera), tcfg, 1, 0, tcfg.seed).numpy()
    assert abs(got.mean() - ref.mean()) < 2e-3
    assert (np.abs(got - ref).max(axis=1) > 2e-3).sum() <= 0.02 * W * H


def test_megakernel_plain_matches_clustered_megakernel_interpret():
    js, ts = _pair(cases.tri_cloud, checker=False)
    jcfg, tcfg = _cfgs(expand_sweep="off", bin_lanes="off")
    ref = np.asarray(j_render_megakernel(js, _camera(j_make_camera), jcfg, 2, 0,
                                         jax.random.key(0), lanes=256, tile_pixels=256,
                                         interpret=True))
    got = megakernel.render_megakernel(ts, _camera(make_camera), tcfg, 2, 0, 0).numpy()
    err = np.abs(got - ref) - (2e-3 + 1e-3 * np.abs(ref))
    assert not (err > 0).any(), np.abs(got - ref).max()


def test_sample_offset_chunks_match_monolithic():
    ts = cases.tri_cloud(tscene, n_tris=135, with_materials=False).build()
    _, cfg = _cfgs()
    cam = _camera(make_camera)
    mono = megakernel.render_megakernel(ts, cam, cfg, 4, 0, 0)
    parts = [megakernel.render_megakernel(ts, cam, cfg, 2, off, 0) for off in (0, 2)]
    torch.testing.assert_close((parts[0] + parts[1]) / 2, mono, atol=1e-5, rtol=0)
    half = W * H // 2
    upper = megakernel.render_megakernel(ts, cam, cfg, 4, 0, 0, pixel_base=half, n_pixels=half)
    assert torch.equal(upper, mono[half:])


def test_megakernel_plain_takes_a_search():
    """A search passed to the plain version replaces the default walk: a
    counting walk over a short run of pixels gives those pixels of the
    whole frame bit for bit."""
    ts = cases.tri_cloud(tscene, n_tris=135, with_materials=False).build()
    _, cfg = _cfgs()
    cam = _camera(make_camera)
    mono = megakernel.render_megakernel_plain(ts, cam, cfg, 2, 0, 0)
    work = {}

    def counting(scene, cfg_, rays):
        c = scene.clusters
        return cluster_ops.cluster_nearest_plain(
            rays, *cluster_ops.cluster_tables(c), c.n_sph_slots, cfg_.t_min, cfg_.t_max,
            cfg_.compat.triangle_backface_cull, work=work)

    run = megakernel.render_megakernel_plain(ts, cam, cfg, 2, 0, 0, pixel_base=300, n_pixels=16,
                                             search=counting)
    assert torch.equal(run, mono[300:316])
    assert work["slab"] > 0 and work["triangle_pairs"] > 0 and work["triangle_clusters"]


def test_wavefront_on_k4_matches_render_fast_and_k5():
    js, ts = _pair(cases.tri_cloud)
    jcfg, tcfg = _cfgs()
    ref = _fast_reference(js, jcfg, 2)
    cam = _camera(make_camera)
    got = wavefront.render_wavefront(ts, cam, torch.arange(W * H, dtype=torch.int32), tcfg, 2, 0,
                                     rng.key(tcfg.seed)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    k5 = megakernel.render_megakernel(ts, cam, tcfg, 2, 0, rng.key_seed(rng.key(tcfg.seed)))
    within = (np.abs(got - k5.numpy()) <= 1e-3 + 1e-3 * np.abs(k5.numpy())).all(axis=-1)
    assert within.mean() >= 0.999


def test_wavefront_walks_the_whole_tables_once_an_iteration():
    """The 9,000-triangle cloud (several pages of 64 clusters, each a K4
    launch an iteration on the JAX package's wavefront) renders through
    one K4 call per iteration over the scene's whole tables, with both
    slot bases left at 0, and its image equals that of the wavefront's own
    intersect, bit for bit."""
    _, cfg = _cfgs(spp=1, max_depth=3)
    cam = _camera(make_camera)
    pix = torch.arange(W * H, dtype=torch.int32)
    scene = cases.tri_cloud(tscene, n_tris=9000, with_materials=False).build()
    assert len(cases.cluster_pages(scene.clusters, 64)) > 2
    calls = []

    def counting(*args):
        calls.append(args)
        return cluster_ops.cluster_worklist_nearest(*args)

    wavefront.COUNTS.update(iterations=0, segments=0)
    img = wavefront.render_wavefront(scene, cam, pix, cfg, 1, 0, rng.key(0), cluster_nearest=counting)
    assert len(calls) == wavefront.COUNTS["iterations"] > 0
    tables = cluster_ops.cluster_tables(scene.clusters)
    assert all(len(a) == 13 and all(x is y for x, y in zip(a[1:9], tables)) for a in calls)
    ref = wavefront.render_wavefront(scene, cam, pix, cfg, 1, 0, rng.key(0))
    assert torch.equal(img, ref)


def test_routing(monkeypatch):
    """"auto" and "megakernel" take K5 on a clustered scene; "wavefront"
    takes K4 once per iteration."""
    ts = cases.tri_cloud(tscene, n_tris=135, with_materials=False).build()
    _, cfg = _cfgs(spp=1, max_depth=3)
    cam = _camera(make_camera)
    k5, walks = [], []
    search = megakernel.cluster_search
    monkeypatch.setattr(megakernel, "cluster_search", lambda *a: k5.append(1) or search(*a))
    plain = cluster_ops.cluster_nearest_plain
    monkeypatch.setattr(cluster_ops, "cluster_nearest_plain",
                        lambda *a: walks.append(1) or plain(*a))
    for renderer in ("auto", "megakernel"):
        k5.clear()
        img = render_pixel_colors(ts, cam, cfg.replace(renderer=renderer), device="cpu")
        assert k5 and img.shape == (H, W, 3)
    k5.clear()
    walks.clear()
    wavefront.COUNTS.update(iterations=0, segments=0)
    render_pixel_colors(ts, cam, cfg.replace(renderer="wavefront"), device="cpu")
    assert not k5 and len(walks) == wavefront.COUNTS["iterations"] > 0


def test_bvh_scenes_refuse_the_unported_traversal():
    """A scene with a BVH renders through K5 and K4, which need no BVH, and
    the routes on which the JAX package walks the BVH (they raised while
    the walk was not ported) walk it too: the chunked path matches JAX."""
    js = cases.tri_cloud(jscene, n_tris=300, with_materials=False).build()
    ts = cases.tri_cloud(tscene, n_tris=300, with_materials=False).build()
    assert ts.bvh is not None
    jcfg, cfg = _cfgs(spp=1, max_depth=2)
    ref = np.asarray(j_render_pixel_colors(js, _camera(j_make_camera), jcfg, wavefront=False))
    got = render_pixel_colors(ts, _camera(make_camera), cfg, device="cpu", wavefront=False)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=1e-3)
    names = {name for name, _ in ts.named_buffers()}
    assert {"clusters.shade_table", "clusters.tri_slots", "bvh.prim_order"} <= names


def test_cli_obj_writes_png(tmp_path):
    from PIL import Image

    from rt_tpu_torch import cli
    from tools.gen_fixtures import make_obj_mesh

    obj = tmp_path / "blob.obj"
    assert make_obj_mesh(str(obj), res=12) == 264
    out = tmp_path / "blob.png"
    assert cli.main(["--scene", f"obj:{obj}", "--camera", "widecam", "--size", "16x9", "--spp",
                     "1", "--max-depth", "3", "--device", "cpu", "--out", str(out)]) == 0
    assert Image.open(out).size == (16, 9)
    assert os.path.getsize(out) > 0
