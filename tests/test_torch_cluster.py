"""The port's cluster tables, BVH builder and K4/K4b against the JAX
package.

- Tables: ``build_bvh`` (both builders), ``build_clusters``,
  ``build_essentials``, ``pack_*_slots`` and the scenes' ``clusters``
  (the whole tables; the JAX package's pages, with their slot bases, cut
  from them) must equal the JAX package's bit for bit:
  the kernels' winner ids are slot ids, so a different table is a
  different image.  The port's native builder is its own copy of the C++
  source, built by the port; the tests assert that it ran, because the
  NumPy builder gives other trees.
- K4 (``cluster_worklist_nearest``) and K4b (``cluster_nearest``): the
  plain version against the interpret-mode Pallas kernels on
  tests/test_cluster.py's rays, and against a brute force over every live
  slot.  Hit masks must be equal; slot ids equal on at least 99.9% of the
  rays; t within rtol 2e-4, the JAX tests' own tolerance (XLA:CPU fuses
  multiply-adds, PyTorch rounds each product).
- Paging: the per-page launches (the JAX package's pages, cut from the
  whole tables by ``torch_cluster_cases.cluster_pages``) merged with a
  strict ``<`` must equal the walk over the whole tables bit for bit.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu import cluster as jcluster
from rt_tpu import scene as jscene
from rt_tpu.bvh import builder as jbuilder
from rt_tpu.bvh import native as jnative
from rt_tpu.pallas_ops import cluster_nearest as j_cluster_nearest
from rt_tpu.pallas_ops import cluster_worklist_nearest as j_worklist
from rt_tpu_torch import cluster, cluster_ops, convert, prim_ops
from rt_tpu_torch import scene as tscene
from rt_tpu_torch.bvh import builder, native
import torch_cluster_cases as cases  # tests/torch_cluster_cases.py

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _jax_native_builder():
    """The JAX side's tables come from its native BVH builder, as the
    port's do from the port's copy."""
    assert cases.load_jax_native(), "the JAX package's native BVH builder did not load"

T_MIN, T_MAX = 1e-3, 1e9


def _aabbs(n, seed):
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-10, 10, (n, 3)).astype(np.float32)
    half = rs.uniform(0.05, 0.5, (n, 1)).astype(np.float32)
    return centers - half, centers + half


def test_native_builders_run():
    """Both packages build their C++ builder here, so the tables below are
    the native builder's."""
    assert native.available() and jnative.available()
    assert builder.which() == "native"


@pytest.mark.parametrize("kind", ["native", "numpy"])
def test_bvh_arrays_identical(kind):
    mins, maxs = _aabbs(700, 3)
    if kind == "native":
        got = builder.build_bvh((mins, maxs))
        ref = jbuilder.build_bvh((mins, maxs))
        arrays = [getattr(got, name).numpy() for name in tscene.BVH_TABLES]
        ref = [np.asarray(getattr(ref, name)) for name in tscene.BVH_TABLES]
    else:
        arrays = builder._build_python(mins, maxs, builder.LEAF_SIZE)
        ref = jbuilder._build_python(mins, maxs, jbuilder.LEAF_SIZE)
    for a, r in zip(arrays, ref, strict=True):
        assert a.dtype == r.dtype
        np.testing.assert_array_equal(a, r)


@pytest.mark.parametrize("n, cap", [(500, None), (6000, 48)])
def test_build_clusters_identical(n, cap):
    """Leaf packing, and with a cluster cap the merge escalation."""
    mins, maxs = _aabbs(n, n)
    got = cluster.build_clusters(mins, maxs, cap)
    ref = jcluster.build_clusters(mins, maxs, cap)
    for a, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(a, r)
    if cap is not None:
        assert int((got[2][:, 0] <= got[2][:, 3]).sum()) <= cap


def test_essentials_and_slot_packing_identical():
    """build_essentials and pack_*_slots on a shade table with checkers,
    image-textured triangles (the 24-row table) and spheres."""
    b = cases.image_tris(tscene)
    b.add_sphere((1, 2, 3), 0.5, b.lambertian(b.checker(0.4, b.solid_color((0.1, 0.2, 0.3)),
                                                         b.solid_color((0.7, 0.8, 0.9)))))
    scene = b.build()
    shade = scene.shade_table.numpy()
    for a, r in zip(cluster.build_essentials(shade), jcluster.build_essentials(shade), strict=True):
        np.testing.assert_array_equal(a, r)
    ess, _, _ = cluster.build_essentials(shade)
    ns = scene.num_spheres
    slots = np.concatenate([np.arange(ns), -np.ones(126, np.int64)])
    args = (slots, scene.sph_center.numpy(), scene.sph_radius.numpy(), ess[:, :ns])
    np.testing.assert_array_equal(cluster.pack_sphere_slots(*args), jcluster.pack_sphere_slots(*args))
    nt = scene.num_triangles
    t_slots = np.concatenate([np.arange(nt)[::-1], -np.ones(256 - nt, np.int64)])
    tri = (scene.tri_a.numpy(), scene.tri_b.numpy(), scene.tri_c.numpy())
    for uva in (None, shade[29:35, ns:]):
        got = cluster.pack_triangle_slots(t_slots, *tri, ess[:, ns:], uva=uva)
        np.testing.assert_array_equal(got, jcluster.pack_triangle_slots(t_slots, *tri, ess[:, ns:],
                                                                        uva=uva))
        assert got.shape == (16 if uva is None else 24, 256)


SCENES = {
    "tri_cloud_150": cases.tri_cloud,
    "spheres_2100": cases.spheres_2100,
    "image_tris_140": cases.image_tris,
    "spheres_16500_paged": cases.spheres_16500,
}


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_cluster_tables_identical(name, monkeypatch):
    """SceneData.clusters (the whole tables) and the rest of the scene; on
    the 16,500-sphere scene, the JAX package's pages of 64 clusters equal
    those cut from the port's whole tables, slot bases included."""
    if name.endswith("paged"):
        monkeypatch.setattr(jscene, "CLUSTER_PAGE", 64)
    got, ref = SCENES[name](tscene).build(), SCENES[name](jscene).build()
    assert got.clusters is not None
    cases.assert_same_scene(got, ref)
    if name.endswith("paged"):
        pages = cases.cluster_pages(got.clusters, 64)
        assert len(pages) == len(ref.clusters.pages) > 2
        for k, ((tables, s_base, t_base), rp) in enumerate(zip(pages, ref.clusters.pages)):
            page = SimpleNamespace(**dict(zip(cases.WALK_TABLES, tables)))
            cases.assert_same_tables(page, rp, cases.PAGE_TABLES, f"pages[{k}].")
            assert (s_base, t_base) == (rp.sph_slot_base, rp.tri_slot_base)
    if name == "image_tris_140":
        assert got.clusters.tri_slots.shape[0] == 24


def test_cluster_data_holds_only_the_walked_tables():
    """A clustered scene's ClusterData is the whole two-level tables, the
    slot-ordered shade table and the slots' primitive ids (by which the
    walks break ties), with no submodules: nothing that no path of the port
    reads is built or moved to the card."""
    cl = cases.tri_cloud(tscene).build().clusters
    names = [name for name, _ in cl.named_buffers()]
    assert sorted(names) == sorted([*cases.WALK_TABLES, "shade_table"])
    assert not list(cl.children())


def test_convert_carries_clusters_and_bvh():
    """A JAX scene with cluster tables and a BVH, carried across."""
    ref = cases.tri_cloud(jscene, n_tris=300).build()
    assert ref.clusters is not None and ref.bvh is not None
    got = convert.scene_from_arrays(jax.tree.map(np.asarray, ref))
    cases.assert_same_scene(got, ref)
    cases.assert_same_scene(cases.tri_cloud(tscene, n_tris=300).build(), ref)


def _assert_k4_parity(got, ref):
    """Hit masks equal; slot ids equal on >= 99.9% of the rays; t within
    rtol 2e-4 on every hit."""
    t, s = (np.asarray(x) for x in got)
    t_ref, s_ref = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(s >= 0, s_ref >= 0)
    assert (s == s_ref).mean() >= 0.999
    hit = s >= 0
    assert (t[~hit] == np.float32(3e38)).all()
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=2e-4, atol=2e-4)
    return hit


def _k4_case():
    """tests/test_cluster.py's scene and rays, for both packages."""
    rs = np.random.default_rng(1234)
    js = cases.cluster_scene(jscene, rs)
    rays = cases.random_rays(rs)
    ts = cases.cluster_scene(tscene, np.random.default_rng(1234))
    return js, ts, rays


def _jax_tables(cl):
    return (cl.sph_super, cl.sph_cluster, cl.sph_slots, cl.tri_super, cl.tri_cluster,
            cl.tri_slots)


_tables = cluster_ops.cluster_tables


@pytest.mark.parametrize("cull", [True, False])
def test_worklist_plain_matches_pallas(cull):
    """K4's plain version against ``_worklist_kernel`` in interpret mode."""
    js, ts, rays = _k4_case()
    jc, tc = js.clusters, ts.clusters
    ref = j_worklist(jnp.asarray(rays), *_jax_tables(jc), jc.n_sph_slots, T_MIN, T_MAX, cull,
                     interpret=True)
    got = cluster_ops.cluster_worklist_nearest(torch.from_numpy(rays), *_tables(tc),
                                               tc.n_sph_slots, T_MIN, T_MAX, cull)
    hit = _assert_k4_parity(got, ref)
    s = got[1].numpy()
    assert hit.sum() > 30 and (s[hit] < tc.n_sph_slots).any() and (s[hit] >= tc.n_sph_slots).any()


def test_cluster_nearest_plain_matches_pallas():
    """K4b's plain version against ``_cluster_kernel`` in interpret mode,
    and equal to K4's."""
    js, ts, rays = _k4_case()
    jc, tc = js.clusters, ts.clusters
    ref = j_cluster_nearest(jnp.asarray(rays), *_jax_tables(jc), jc.n_sph_slots, T_MIN, T_MAX,
                            True, interpret=True)
    got = cluster_ops.cluster_nearest(torch.from_numpy(rays), *_tables(tc), tc.n_sph_slots,
                                      T_MIN, T_MAX, True)
    _assert_k4_parity(got, ref)
    k4 = cluster_ops.cluster_worklist_nearest(torch.from_numpy(rays), *_tables(tc), tc.n_sph_slots,
                                              T_MIN, T_MAX, True)
    assert all(torch.equal(a, b) for a, b in zip(got, k4))


def _brute_force_slots(rays, cl, cull):
    """The nearest hit over every live slot, by K3b's plain version on the
    slot tables laid out as packed tables (slot ids for primitive ids)."""
    sph = cl.sph_slots[0:4].T.contiguous()
    tri = torch.zeros((cl.tri_slots.shape[1], 12))
    tri[:, :10] = cl.tri_slots[0:10].T
    return prim_ops.prim_nearest_packed_plain(rays, sph, tri, cl.n_sph_slots, T_MIN, T_MAX, cull)


@pytest.mark.parametrize("name", ["tri_cloud_150", "image_tris_140"])
def test_plain_matches_brute_force_over_live_slots(name):
    """Rays from the camera side and from inside the clouds: the walk's
    culling never drops the nearest hit."""
    scene = SCENES[name](tscene).build()
    cl = scene.clusters
    rs = np.random.default_rng(8)
    rays = cases.random_rays(rs, n=512, extent=3.5)
    rays[0:3, :256] = np.array([[6.0], [0.0], [2.0]]) + rs.normal(scale=0.1, size=(3, 256))
    rays[3:6, :256] = -rays[0:3, :256] + rs.uniform(-2, 2, (3, 256))
    rays = torch.from_numpy(rays)
    for cull in (True, False):
        got = cluster_ops.cluster_nearest(rays, *_tables(cl), cl.n_sph_slots, T_MIN, T_MAX, cull)
        ref = _brute_force_slots(rays, cl, cull)
        hit = _assert_k4_parity(got, ref)
        assert hit.mean() > 0.3


def test_paged_merge_equals_single_page():
    """Pages of 64 clusters launched one by one and merged with a strict
    ``<``, as the JAX package's wavefront merges them, against the walk
    over the whole tables: t and slot ids bit for bit."""
    scene = cases.spheres_16500(tscene).build()
    cl = scene.clusters
    pages = cases.cluster_pages(cl, 64)
    assert len(pages) > 2 and cl.sph_cluster.shape[0] > 128
    rays = torch.from_numpy(cases.random_rays(np.random.default_rng(1234), extent=8.0))
    whole = cluster_ops.cluster_nearest(rays, *_tables(cl), cl.n_sph_slots, T_MIN, T_MAX, True)
    t_best = torch.full((256,), 3e38)
    s_best = torch.full((256,), -1, dtype=torch.int32)
    for tables, s_base, t_base in pages:
        t_p, s_p = cluster_ops.cluster_worklist_nearest(
            rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, True, s_base, t_base)
        better = t_p < t_best
        t_best, s_best = torch.where(better, t_p, t_best), torch.where(better, s_p, s_best)
    assert torch.equal(t_best, whole[0]) and torch.equal(s_best, whole[1])
    assert (whole[1] >= 0).sum() > 20 and (whole[1] >= 64 * 128).any()


def test_walk_work_names_entered_clusters_globally():
    """The plain walk's work counts name the clusters and supers some ray
    entered by their index in the unpaged tables: every winner's cluster is
    among them, each is a live cluster, and the pages' walks (each from a
    fresh best t) enter at least the clusters the whole tables' walk does."""
    cl = cases.spheres_16500(tscene).build().clusters
    rays = torch.from_numpy(cases.random_rays(np.random.default_rng(1234), extent=8.0))
    whole = {}
    _, slot = cluster_ops.cluster_nearest_plain(rays, *_tables(cl), cl.n_sph_slots, T_MIN, T_MAX,
                                                True, work=whole)
    paged = {}
    for tables, s_base, t_base in cases.cluster_pages(cl, 64):
        cluster_ops.cluster_nearest_plain(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, True,
                                          s_base, t_base, work=paged)
    entered = whole["sphere_clusters"]
    live = (cl.sph_cluster[:, 0] <= cl.sph_cluster[:, 3]).numpy()
    winners = {s // 128 for s in slot[slot >= 0].tolist()}
    assert winners and winners <= entered <= paged["sphere_clusters"]
    assert all(live[c] for c in entered) and max(entered) >= 64
    assert {c // 64 for c in entered} <= whole["sphere_supers"] <= paged["sphere_supers"]
    assert whole["sphere_pairs"] <= paged["sphere_pairs"] and not whole["triangle_clusters"]
