"""The modules of the wavefront's generic path (geometry, materials,
textures) against the JAX package's functions of the same names.

Inputs come from seeded numpy generators and scenes both packages build
from the same calls.  Tolerances: values at atol 1e-5 (rtol 1e-5 for t),
the rounding of the same float32 operations in another order (XLA:CPU
fuses multiply-adds); discrete results (winners, front faces, materials,
texel choices) equal.
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch import geometry, materials, textures
from rt_tpu_torch.config import CompatConfig
from rt_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _scene(builder_cls):
    """Spheres and triangles with every texture kind: solid, checker,
    image, and a checker with an image child; every material kind."""
    rs = np.random.default_rng(3)
    b = builder_cls()
    img = rs.uniform(0, 1, (6, 5, 3)).astype(np.float32)
    solid = b.solid_color((0.2, 0.5, 0.8))
    tex = [solid, b.checker(0.7, solid, b.solid_color((0.9, 0.1, 0.1))), b.image_texture(img),
           b.checker(0.4, b.image_texture(img[::-1].copy()), solid)]
    mats = [b.lambertian(tex[0]), b.lambertian(tex[1]), b.metal(tex[2], 0.3), b.lambertian(tex[3]),
            b.dielectric(1.5), b.dielectric(1.3, 0.1), b.emissive((2.0, 1.5, 1.0))]
    for k in range(24):
        b.add_sphere(rs.uniform(-3, 3, 3), rs.uniform(0.3, 0.9), mats[k % len(mats)],
                     front_direction=rs.normal(size=3))
    for k in range(6):
        b.add_triangle(*rs.uniform(-4, 4, (3, 3)), mats[k % len(mats)],
                       uv_a=(0.1, 0.2), uv_b=(0.9, 0.1), uv_c=(0.4, 0.8))
    return b.build()


def _pair():
    from rt_tpu.scene import SceneBuilder as JBuilder

    return _scene(JBuilder), _scene(SceneBuilder)


def _rays(n=600, seed=5):
    rs = np.random.default_rng(seed)
    org = rs.uniform(-6, 6, (n, 3)).astype(np.float32)
    target = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    return org, (target - org).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("cull", [True, False])
def test_nearest_hit_matches_jax(cull):
    """nearest_hit_bruteforce, hit_attributes and the three impls of
    nearest_hit."""
    import jax.numpy as jnp
    from rt_tpu import geometry as jgeometry
    from rt_tpu.config import CompatConfig as JCompat

    js, ts = _pair()
    org, dirn = _rays()
    jc, tc = JCompat(triangle_backface_cull=cull), CompatConfig(triangle_backface_cull=cull)
    jargs, targs = (jnp.asarray(org), jnp.asarray(dirn)), (torch.from_numpy(org), torch.from_numpy(dirn))
    ts_c = jgeometry.sphere_candidate_t(*jargs, js.sph_center, js.sph_radius, 1e-3, 3e38)
    ts_t = geometry.sphere_candidate_t(*targs, ts.sph_center, ts.sph_radius, 1e-3, 3e38)
    np.testing.assert_allclose(_np(ts_t), _np(ts_c), **TOL)
    t_j, p_j = jgeometry.nearest_hit_bruteforce(js, *jargs, 1e-3, 3e38, jc)
    t_t, p_t = geometry.nearest_hit_bruteforce(ts, *targs, 1e-3, 3e38, tc)
    np.testing.assert_array_equal(_np(p_t), _np(p_j))
    np.testing.assert_allclose(_np(t_t), _np(t_j), **TOL)
    p = _np(p_t)
    assert (p < 0).any() and ((p >= 0) & (p < 24)).any() and (p >= 24).any()

    ref = jgeometry.hit_attributes(js, *jargs, t_j, p_j, jc)
    got = geometry.hit_attributes(ts, *targs, t_t, p_t, tc)
    for field in ("prim", "hit", "front", "material"):
        np.testing.assert_array_equal(_np(getattr(got, field)), _np(getattr(ref, field)), field)
    for field in ("t", "point", "normal", "uv"):
        np.testing.assert_allclose(_np(getattr(got, field)), _np(getattr(ref, field)), **TOL)
    # K2's sphere test subtracts the center first; the matrix-product form
    # expands |o - c|^2 and cancels (|o|^2 reaches ~100 here), so the hit
    # points of K2's impl agree to atol 1e-4.
    rec = geometry.nearest_hit(ts, *targs, 1e-3, 3e38, tc, impl="pallas")
    np.testing.assert_array_equal(_np(rec.prim), _np(ref.prim))
    np.testing.assert_allclose(_np(rec.point), _np(ref.point), rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="impl"):
        geometry.nearest_hit(ts, *targs, 1e-3, 3e38, tc, impl="bvh")


def test_uv_helpers_match_jax():
    import jax.numpy as jnp
    from rt_tpu import geometry as jgeometry
    from rt_tpu.config import CompatConfig as JCompat

    rs = np.random.default_rng(8)
    p = rs.normal(size=(500, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    face = rs.normal(size=(500, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(geometry.sphere_uv_facing(torch.from_numpy(p), torch.from_numpy(face))),
        _np(jgeometry.sphere_uv_facing(jnp.asarray(p), jnp.asarray(face))), **TOL)
    np.testing.assert_allclose(
        _np(geometry.unit_sphere_uv(torch.from_numpy(p), 0.3, -1.1, 0.7)),
        _np(jgeometry.unit_sphere_uv(jnp.asarray(p), 0.3, -1.1, 0.7)), **TOL)
    uv = rs.uniform(0, 1, (500, 3, 2)).astype(np.float32)
    u, v = rs.uniform(0, 0.5, (2, 500)).astype(np.float32)
    for remap in (True, False):
        np.testing.assert_allclose(
            _np(geometry.triangle_uv(torch.from_numpy(uv), torch.from_numpy(u), torch.from_numpy(v),
                                     CompatConfig(triangle_uv_bbox_remap=remap))),
            _np(jgeometry.triangle_uv(jnp.asarray(uv), jnp.asarray(u), jnp.asarray(v),
                                      JCompat(triangle_uv_bbox_remap=remap))), **TOL)


def test_materials_and_textures_match_jax():
    """reflect, refract, Schlick, texture_value and scatter_hashed on the
    same hit records, with the same hash draws."""
    import jax.numpy as jnp
    from rt_tpu import geometry as jgeometry, materials as jmaterials, textures as jtextures
    from rt_tpu.config import CompatConfig as JCompat

    rs = np.random.default_rng(9)
    d = rs.normal(size=(400, 3)).astype(np.float32)
    n = rs.normal(size=(400, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ud = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ratio = rs.uniform(0.6, 1.6, (400, 1)).astype(np.float32)
    cos = rs.uniform(-1, 1, 400).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    np.testing.assert_allclose(_np(materials.reflect(T(d), T(n))), _np(jmaterials.reflect(J(d), J(n))), **TOL)
    np.testing.assert_allclose(_np(materials.refract(T(ud), T(n), T(ratio))),
                               _np(jmaterials.refract(J(ud), J(n), J(ratio))), **TOL)
    np.testing.assert_allclose(_np(materials.schlick_reflectance(T(cos), T(ratio[:, 0]))),
                               _np(jmaterials.schlick_reflectance(J(cos), J(ratio[:, 0]))), **TOL)

    js, ts = _pair()
    tex_id = rs.integers(0, ts.tex_kind.shape[0], 400).astype(np.int32)
    uv = rs.uniform(-0.2, 1.2, (400, 2)).astype(np.float32)
    point = rs.uniform(-3, 3, (400, 3)).astype(np.float32)
    np.testing.assert_array_equal(_np(textures.texture_value(ts, T(tex_id), T(uv), T(point))),
                                  _np(jtextures.texture_value(js, J(tex_id), J(uv), J(point))))

    org, dirn = _rays(seed=10)
    t, prim = jgeometry.nearest_hit_bruteforce(js, J(org), J(dirn), 1e-3, 3e38, JCompat())
    jrec = jgeometry.hit_attributes(js, J(org), J(dirn), t, prim, JCompat())
    trec = geometry.hit_attributes(ts, T(org), T(dirn), T(np.array(t)), T(np.array(prim)),
                                   CompatConfig())
    work, depth = np.arange(600, dtype=np.int32), np.full(600, 2, np.int32)
    att_j, dir_j = jmaterials.scatter_hashed(js, jrec, J(dirn), 7, J(work), J(depth), JCompat())
    att_t, dir_t = materials.scatter_hashed(ts, trec, T(dirn), 7, T(work).long(), T(depth).long())
    hit = _np(trec.hit)
    assert hit.sum() > 100
    np.testing.assert_array_equal(_np(att_t)[hit], _np(att_j)[hit])
    np.testing.assert_allclose(_np(dir_t)[hit], _np(dir_j)[hit], rtol=1e-4, atol=1e-4)
