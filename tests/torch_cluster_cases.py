"""Shared by the port's tests of clustered scenes: the scenes of
tests/test_megakernel_cluster.py and tests/test_cluster.py, built with
either package's SceneBuilder from the same seeds, and a table-by-table
comparison of a port scene with a JAX package scene (every table, the
cluster tables with their pages and slot bases, the BVH arrays and the sky
equal bit for bit)."""

import time

import numpy as np

from rt_tpu_torch.scene import BVH_TABLES, CLUSTER_TABLES, PAGE_TABLES, TABLES


def load_jax_native(seconds: float = 120.0) -> bool:
    """Load the JAX package's native BVH builder, which its cluster tables
    need.  Its loader builds the library in place on first use and, if a
    load fails while another test process is still writing the file,
    falls back to the NumPy builder for the rest of the process; retry
    until the file is complete."""
    from rt_tpu.bvh import native as jnative

    deadline = time.monotonic() + seconds
    while not jnative.available():
        if time.monotonic() > deadline:
            return False
        time.sleep(1.0)
        jnative._load_failed = False
    return True


def assert_same_tables(got, ref, names, where=""):
    for name in names:
        r = getattr(ref, name)
        g = getattr(got, name)
        if r is None:
            assert g is None, where + name
            continue
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype, where + name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=where + name)


def assert_same_clusters(got, ref):
    assert (got is None) == (ref is None)
    if ref is None:
        return
    assert_same_tables(got, ref, CLUSTER_TABLES, "clusters.")
    assert (got.n_sph_slots, got.inline_ok, got.chord_clusters) == (
        ref.n_sph_slots, ref.inline_ok, ref.chord_clusters)
    assert len(got.pages) == len(ref.pages)
    for k, (gp, rp) in enumerate(zip(got.pages, ref.pages)):
        assert_same_tables(gp, rp, PAGE_TABLES, f"pages[{k}].")
        assert (gp.sph_slot_base, gp.tri_slot_base) == (rp.sph_slot_base, rp.tri_slot_base)


def assert_same_scene(got, ref):
    assert_same_tables(got, ref, TABLES)
    assert (got.num_spheres, got.num_triangles, got.has_image_textures) == (
        ref.num_spheres, ref.num_triangles, ref.has_image_textures)
    for name in ("sun_direction", "turbidity", "exposure"):
        np.testing.assert_array_equal(getattr(got.sky, name).numpy(),
                                      np.asarray(getattr(ref.sky, name)))
    assert (got.sky.hw_params is None) == (ref.sky.hw_params is None)
    assert got.sky.cos_gamma_as_angle == ref.sky.cos_gamma_as_angle
    assert_same_clusters(got.clusters, ref.clusters)
    assert (got.bvh is None) == (ref.bvh is None)
    if ref.bvh is not None:
        assert_same_tables(got.bvh, ref.bvh, BVH_TABLES, "bvh.")


def tri_cloud(mod, n_tris=150, with_materials=True, seed=0, checker=True):
    """test_megakernel_cluster.py's ``_tri_cloud_scene``; ``mod`` is
    ``rt_tpu.scene`` or ``rt_tpu_torch.scene``.  Without ``checker`` the
    checker material is a solid lambertian and the metal has no fuzz."""
    rng = np.random.default_rng(seed)
    b = mod.SceneBuilder()
    g = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
    b.add_sphere((0, 0, -1000), 1000, g)
    mats = [b.metal(b.solid_color((0.8, 0.7, 0.6)), fuzz=0.1 if checker else None)]
    if with_materials:
        mats += [
            b.lambertian(b.checker(0.5, b.solid_color((0.1, 0.2, 0.3)),
                                   b.solid_color((0.9, 0.9, 0.8))))
            if checker else b.lambertian_rgb(0.3, 0.6, 0.9),
            b.dielectric(1.5),
            b.emissive((2.0, 1.5, 1.0)),
        ]
    for i in range(n_tris):
        c = rng.uniform(-3, 3, 3)
        c[2] = rng.uniform(0.2, 2.0)
        d1 = rng.uniform(-0.3, 0.3, 3)
        d2 = rng.uniform(-0.3, 0.3, 3)
        b.add_triangle(tuple(c), tuple(c + d1), tuple(c + d2), mats[i % len(mats)])
    b.add_sphere((0, 0, 1), 1, b.lambertian(b.solid_color((0.8, 0.2, 0.1))))
    return b


def spheres_2100(mod):
    """test_megakernel_cluster.py's sphere-heavy scene: 2100 small spheres
    on a ground sphere."""
    rng = np.random.default_rng(1)
    b = mod.SceneBuilder()
    g = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
    b.add_sphere((0, 0, -1000), 1000, g)
    for _ in range(2100):
        c = rng.uniform(-8, 8, 3)
        c[2] = rng.uniform(0.1, 1.5)
        b.add_sphere(tuple(c), 0.08, g)
    return b


def image_tris(mod):
    """test_megakernel_cluster.py's 140 image-textured triangles (the
    24-row triangle slot table)."""
    rng = np.random.default_rng(7)
    b = mod.SceneBuilder()
    b.add_sphere((0, 0, -1000), 1000, b.lambertian(b.solid_color((0.5, 0.5, 0.5))))
    img = rng.uniform(0.1, 1.0, (16, 16, 3)).astype(np.float32)
    mat = b.metal(b.image_texture(img), fuzz=0.05)
    for _ in range(140):
        c = rng.uniform(-3, 3, 3)
        c[2] = rng.uniform(0.2, 2.0)
        d1 = rng.uniform(-0.4, 0.4, 3)
        d2 = rng.uniform(-0.4, 0.4, 3)
        uv = rng.uniform(0, 1, (3, 2))
        b.add_triangle(tuple(c), tuple(c + d1), tuple(c + d2), mat,
                       uv_a=tuple(uv[0]), uv_b=tuple(uv[1]), uv_c=tuple(uv[2]))
    return b


def spheres_16500(mod):
    """test_cluster.py's paged scene: 16,500 spheres (with pages of 64
    clusters, three sphere pages)."""
    rng = np.random.default_rng(1234)
    b = mod.SceneBuilder()
    m = b.lambertian_rgb(0.6, 0.5, 0.4)
    for c, r in zip(rng.uniform(-40, 40, (16500, 3)), rng.uniform(0.2, 0.5, 16500)):
        b.add_sphere(c, r, m)
    return b


def cluster_scene(mod, rng, n_sph=300, n_tri=200):
    """test_cluster.py's ``_cluster_scene``: random spheres and triangles,
    no BVH."""
    b = mod.SceneBuilder()
    for _ in range(n_sph):
        m = b.lambertian_rgb(*rng.uniform(0.2, 0.9, 3))
        b.add_sphere(rng.uniform(-8, 8, 3), rng.uniform(0.2, 0.8), m)
    mt = b.metal_solid((0.8, 0.7, 0.6), 0.1)
    for _ in range(n_tri):
        base = rng.uniform(-8, 8, 3)
        b.add_triangle(base, base + rng.normal(size=3), base + rng.normal(size=3), mt)
    return b.build(use_bvh=False)


def random_rays(rng, n=256, extent=10.0):
    """test_cluster.py's rays in the kernel layout f32[8, n]."""
    rays = np.zeros((8, n), np.float32)
    rays[0:3] = rng.uniform(-extent, extent, (3, n))
    rays[3:6] = rng.normal(size=(3, n))
    return rays
