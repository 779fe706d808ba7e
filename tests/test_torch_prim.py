"""K3/K3b, the nearest-primitive kernel, against the JAX package's Pallas
kernels.

``rt_tpu.pallas_ops.prim_nearest_packed`` (K3b) and ``prim_nearest_shaded``
(K3) run in interpret mode, as tests/test_pallas_prim.py runs them, on
scene tables built by both packages from the same calls and rays drawn from
a seeded numpy generator.  Tolerances:
- the winner (global id, -1 on a miss) must be equal on every ray: it
  feeds every later decision of a path;
- t must be BIG on every miss and agree on every hit at rtol 1e-4: XLA:CPU
  fuses multiply-adds where PyTorch rounds each product, and both the
  sphere discriminant and the triangle determinant cancel near grazing hits
  (tests/test_torch_nearest.py measured 5.9e-5 for the spheres);
- the fetched shade-table columns must be equal exactly: both sides copy
  the winner's column.
The CUDA kernel is held against the plain version by the ``cuda`` test at
the end, which runs only where a card is present: built without fused
multiply-adds, it must agree bit for bit.  ``rt_tpu`` is imported inside
the CPU tests, so that the ``cuda`` test also runs on a machine without the
JAX package's dependencies.
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch import prim_ops
from rt_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)

T_MIN, T_MAX = 1e-3, 3.0e38


def _build(builder_cls):
    """150 spheres (one duplicated: an exact tie) and 70 triangles (one
    duplicated), so that both tables take two tiles of the kernel."""
    rs = np.random.default_rng(7)
    b = builder_cls()
    mats = [b.lambertian_rgb(*rs.uniform(0.1, 0.9, 3)), b.metal_solid((0.7, 0.6, 0.5), 0.2),
            b.dielectric(1.5)]
    centers = rs.uniform(-4, 4, (150, 3))
    radii = rs.uniform(0.2, 0.9, 150)
    centers[149], radii[149] = centers[5], radii[5]
    for k in range(150):
        b.add_sphere(centers[k], radii[k], mats[k % 3])
    verts = rs.uniform(-5, 5, (70, 3, 3))
    verts[69] = verts[12]
    for k in range(70):
        b.add_triangle(*verts[k], mats[k % 3])
    return b.build()


def _rays(n=512, n_pad=64, seed=11):
    """n rays in the kernel layout: the last n_pad are the wavefront's idle
    lanes (origin 0, direction (1, 1, 1)); a quarter point upward from
    above the scene, which miss."""
    rs = np.random.default_rng(seed)
    rays = np.zeros((8, n), np.float32)
    rays[0:3] = rs.uniform(-6, 6, (3, n))
    rays[3:6] = rs.normal(size=(3, n))
    up = slice(0, n // 4)
    rays[2, up], rays[5, up] = 10.0, np.abs(rays[5, up]) + 0.1
    rays[0:3, n - n_pad:], rays[3:8, n - n_pad:] = 0.0, 1.0
    return rays


def _jax_scene():
    from rt_tpu.scene import SceneBuilder as JBuilder

    return _build(JBuilder)


def _assert_same(got, ref):
    t, i = (x.numpy() for x in got)
    t_ref, i_ref = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(i, i_ref)
    hit = i >= 0
    assert (t[~hit] == np.float32(3e38)).all()
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-4, atol=0)


def test_tables_match_jax_builder():
    """The packed tables the kernels read are the JAX SceneBuilder's."""
    js, ts = _jax_scene(), _build(SceneBuilder)
    for name in ("sph_packed", "tri_packed", "shade_table"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    assert ts.sph_packed.shape == (256, 4) and ts.tri_packed.shape == (128, 12)


@pytest.mark.parametrize("cull", [True, False])
def test_packed_plain_matches_pallas_interpret(cull):
    """K3b: hits on spheres and triangles, misses and idle lanes."""
    import jax.numpy as jnp
    from rt_tpu import pallas_ops

    js, ts = _jax_scene(), _build(SceneBuilder)
    rays = _rays()
    ref = pallas_ops.prim_nearest_packed(jnp.asarray(rays), js.sph_packed, js.tri_packed,
                                         js.num_spheres, T_MIN, T_MAX, cull, interpret=True)
    got = prim_ops.prim_nearest_packed(torch.from_numpy(rays), ts.sph_packed, ts.tri_packed,
                                       ts.num_spheres, T_MIN, T_MAX, cull)
    _assert_same(got, ref)
    i = got[1].numpy()
    assert (i == -1).any() and ((i >= 0) & (i < 150)).any() and (i >= 150).any()
    assert not (i == 149).any() and not (i == 150 + 69).any()  # ties go to the lower id
    again = prim_ops.prim_nearest_packed_plain(torch.from_numpy(rays), ts.sph_packed,
                                               ts.tri_packed, ts.num_spheres, T_MIN, T_MAX, cull)
    _assert_same(again, ref)


def test_shaded_plain_matches_pallas_interpret():
    """K3: the same winners, and the winners' shade-table columns."""
    import jax.numpy as jnp
    from rt_tpu import pallas_ops

    js, ts = _jax_scene(), _build(SceneBuilder)
    rays = _rays(seed=12)
    t_r, i_r, p_r = pallas_ops.prim_nearest_shaded(
        jnp.asarray(rays), js.sph_packed, js.tri_packed, js.shade_table, js.num_spheres,
        T_MIN, T_MAX, True, interpret=True)
    t, i, params = prim_ops.prim_nearest_shaded(torch.from_numpy(rays), ts.sph_packed,
                                                ts.tri_packed, ts.shade_table, ts.num_spheres,
                                                T_MIN, T_MAX, True)
    _assert_same((t, i), (t_r, i_r))
    assert params.shape == (40, 512)
    np.testing.assert_array_equal(params.numpy(), np.asarray(p_r))
    np.testing.assert_array_equal(params.numpy()[:, i.numpy() < 0],
                                  np.repeat(ts.shade_table.numpy()[:, :1], (i < 0).sum().item(), 1))


def _nearest_before(rays, sph, tri, n_spheres, t_min, t_max, cull):
    """K1's plain search as it was before it moved onto K3b's plain
    version: the sphere search, then fast_shade's brute-force triangle
    search of that time, merged."""
    from rt_tpu_torch.nearest_ops import BIG, sphere_nearest_packed_plain

    t_best, prim = sphere_nearest_packed_plain(rays, sph, t_min, t_max)
    if tri.shape[0]:
        ox, oy, oz = rays[0][None], rays[1][None], rays[2][None]
        dx, dy, dz = rays[3][None], rays[4][None], rays[5][None]
        ax_, ay_, az_ = tri[:, 0:1], tri[:, 1:2], tri[:, 2:3]
        e1x, e1y, e1z = tri[:, 3:4], tri[:, 4:5], tri[:, 5:6]
        e2x, e2y, e2z = tri[:, 6:7], tri[:, 7:8], tri[:, 8:9]
        uvx = dy * e2z - dz * e2y
        uvy = dz * e2x - dx * e2z
        uvz = dx * e2y - dy * e2x
        det = e1x * uvx + e1y * uvy + e1z * uvz
        det_ok = det > 1e-7 if cull else torch.abs(det) > 1e-7
        inv_det = 1.0 / torch.where(det_ok, det, 1.0)
        aox, aoy, aoz = ox - ax_, oy - ay_, oz - az_
        u = (aox * uvx + aoy * uvy + aoz * uvz) * inv_det
        vvx = aoy * e1z - aoz * e1y
        vvy = aoz * e1x - aox * e1z
        vvz = aox * e1y - aoy * e1x
        v = (dx * vvx + dy * vvy + dz * vvz) * inv_det
        t = (e2x * vvx + e2y * vvy + e2z * vvz) * inv_det
        ok = (det_ok & (tri[:, 9:10] > 0.5) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t >= t_min) & (t < t_max) & (t > 1e-7))
        t = torch.where(ok, t, BIG)
        t_t, idx = torch.min(t, dim=0)
        id_t = torch.where(t_t < BIG, idx, -1)
        better = t_t < t_best
        t_best = torch.where(better, t_t, t_best)
        prim = torch.where(better, id_t + n_spheres, prim)
    return t_best, prim


def test_megakernel_plain_unchanged(monkeypatch):
    """K1's plain version now intersects through K3b's plain version: its
    image of the cover scene (glass, metal, image texture, ground
    triangles) is bit for bit the image of the search it used before."""
    from rt_tpu_torch import megakernel, scenes
    from rt_tpu_torch.config import RenderConfig

    camera = scenes.cam1(24, 16)
    scene = scenes.cover_scene(3, 3, camera, z=-0.2, seed=0)
    cfg = RenderConfig(width=24, height=16, samples_per_pixel=2, max_depth=10)
    now = megakernel.render_megakernel_plain(scene, camera, cfg, 2, 0, 0)
    monkeypatch.setattr(megakernel.prim_ops, "prim_nearest_packed_plain", _nearest_before)
    before = megakernel.render_megakernel_plain(scene, camera, cfg, 2, 0, 0)
    assert torch.equal(now, before) and now.abs().max() > 0


def test_wrappers_check_shapes():
    ts = _build(SceneBuilder)
    rays = torch.from_numpy(_rays())
    for bad in (rays[:, :300], rays[:6]):
        with pytest.raises(ValueError, match="prim_nearest_packed"):
            prim_ops.prim_nearest_packed(bad, ts.sph_packed, ts.tri_packed, ts.num_spheres,
                                         T_MIN, T_MAX)
    with pytest.raises(ValueError, match="prim_nearest_shaded"):
        prim_ops.prim_nearest_shaded(rays, ts.sph_packed[:100], ts.tri_packed, ts.shade_table,
                                     ts.num_spheres, T_MIN, T_MAX)
    with pytest.raises(ValueError, match="prim_nearest_shaded"):
        prim_ops.prim_nearest_shaded(rays, ts.sph_packed, ts.tri_packed[:, :9], ts.shade_table,
                                     ts.num_spheres, T_MIN, T_MAX)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """K3 and K3b on the card against the plain version on the card: equal
    winners, t and params, bit for bit, with culling on and off, on this
    file's scene and on the tie scene of tests/torch_brute_cases.py
    (repeated spheres and triangles, a sphere and a triangle at equal t,
    near roots below t_min, misses)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from torch_brute_cases import tie_rays, tie_scene

    rays = torch.from_numpy(_rays(n=4096, n_pad=256, seed=14)).cuda()
    cases = ((_build(SceneBuilder).to("cuda"), rays), (tie_scene().to("cuda"), tie_rays().cuda()))
    for ts, rays in cases:
        for cull in (True, False):
            args = (rays, ts.sph_packed, ts.tri_packed)
            before = dict(prim_ops.LAUNCHES)
            got = prim_ops.prim_nearest_shaded(*args, ts.shade_table, ts.num_spheres, T_MIN, T_MAX,
                                               cull)
            got_b = prim_ops.prim_nearest_packed(*args, ts.num_spheres, T_MIN, T_MAX, cull)
            assert prim_ops.LAUNCHES["prim_nearest_shaded"] == before["prim_nearest_shaded"] + 1
            assert prim_ops.LAUNCHES["prim_nearest_packed"] == before["prim_nearest_packed"] + 1
            ref = prim_ops.prim_nearest_shaded_plain(*args, ts.shade_table, ts.num_spheres, T_MIN,
                                                     T_MAX, cull)
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            for a, b in zip(got_b, ref[:2]):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
