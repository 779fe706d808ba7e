"""The persistent wavefront against the JAX package's, and within the port.

Both packages draw every random number from the counter hash keyed on the
global work id, so images are compared per sample: atol/rtol 1e-3 per
value, the JAX package's megakernel parity tolerance.  JAX runs on the CPU,
where its fast path intersects with the XLA searches of fast_shade (the
same function as the Pallas kernel K3) and its generic path with the
brute-force sphere test in matrix-product form.

One scene needs the fraction form of tests/test_fast_shade.py instead: the
nested checker's ground is a sphere of radius 1000, and JAX's
matrix-product sphere test (rt_tpu/geometry.py:59) loses digits to
cancellation there that K2's form keeps, which can move a hit point across
a checker edge or flip a later Russian-roulette or Fresnel decision.
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch import fast_shade, megakernel, prim_ops, rng, scenes, wavefront
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.render import render_pixel_colors
from rt_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)

TOL = dict(rtol=1e-3, atol=1e-3)


def _nested_checker(builder_cls):
    """A checker whose even child is an image: no shade table."""
    b = builder_cls()
    img = np.linspace(0.2, 0.9, 4 * 4 * 3, dtype=np.float32).reshape(4, 4, 3)
    ck = b.checker(0.5, b.image_texture(img), b.solid_color((0.9, 0.9, 0.9)))
    b.add_sphere((0, 0, -1000), 1000, b.lambertian(ck))
    b.add_sphere((0, 0, 1), 1, b.metal_solid((0.8, 0.7, 0.6), 0.1))
    b.add_sphere((1.5, -1, 0.6), 0.6, b.dielectric(1.5))
    return b.build()


def _sky_only(builder_cls):
    b = builder_cls()
    b.lambertian_rgb(0.5, 0.5, 0.5)
    return b.build()


# name: (scene(scenes module, builder class, camera), camera, W, H, spp,
# max_depth, sample_offset, pool_size)
CASES = {
    "cover": (lambda m, b, c: m.cover_scene(2, 2, c, z=-0.2, seed=0), "cam1", 24, 16, 4, 10, 0, 1 << 16),
    "defocus_cam2": (lambda m, b, c: m.cover_scene(2, 2, c, z=-0.2, seed=1), "cam2", 16, 12, 2, 6, 0, 1 << 16),
    "sky_only": (lambda m, b, c: _sky_only(b), "cam1", 16, 8, 1, 4, 0, 1 << 16),
    "nested_checker": (lambda m, b, c: _nested_checker(b), "cam1", 16, 12, 2, 6, 0, 1 << 16),
    "more_work_than_pool": (lambda m, b, c: m.cover_scene(1, 1, c, seed=0), "cam1", 8, 8, 16, 6, 0, 256),
    "two_phase": (lambda m, b, c: m.cover_scene(2, 2, c, z=-0.2, seed=0), "cam1", 64, 64, 4, 6, 0, 1 << 16),
    # sample * W * H passes 2**31 at sample 5,592,406: gwork wraps in int32.
    "gwork_wraps": (lambda m, b, c: m.cover_scene(2, 2, c, z=-0.2, seed=0), "cam1", 24, 16, 2, 6, 6_000_000, 1 << 16),
}


def _pair(name):
    """(JAX scene, camera, cfg), (port scene, camera, cfg) and the run's
    spp, sample offset and pool size."""
    from rt_tpu import scenes as jscenes
    from rt_tpu.config import RenderConfig as JConfig
    from rt_tpu.scene import SceneBuilder as JBuilder

    make, cam, w, h, spp, depth, offset, pool = CASES[name]
    jcam, tcam = getattr(jscenes, cam)(w, h), getattr(scenes, cam)(w, h)
    j = (make(jscenes, JBuilder, jcam), jcam, JConfig(width=w, height=h, max_depth=depth))
    t = (make(scenes, SceneBuilder, tcam), tcam, RenderConfig(width=w, height=h, max_depth=depth))
    return j, t, spp, offset, pool


@pytest.mark.parametrize("fn", ["render_wavefront", "_render_generic"])
@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name, fn):
    """render_wavefront (the fast path wherever there is a shade table) and
    _render_generic against the JAX functions of the same names."""
    import jax
    import jax.numpy as jnp
    from rt_tpu import wavefront as jwavefront

    (js, jcam, jcfg), (ts, tcam, tcfg), spp, offset, pool = _pair(name)
    n = tcam.image_width * tcam.image_height
    ref = np.asarray(getattr(jwavefront, fn)(js, jcam, jnp.arange(n, dtype=jnp.int32), jcfg, spp,
                                             jnp.int32(offset), jax.random.key(0), pool))
    got = getattr(wavefront, fn)(ts, tcam, torch.arange(n, dtype=torch.int32), tcfg, spp, offset,
                                 rng.key(0), pool).numpy()
    assert got.shape == (n, 3) and np.isfinite(got).all() and got.max() > 0
    if name == "nested_checker":  # see the module docstring
        assert np.isclose(got, ref, **TOL).mean() > 0.99
        assert abs(got.mean() - ref.mean()) < 0.01
    else:
        np.testing.assert_allclose(got, ref, **TOL)
    assert (ts.shade_table is None) == (name in ("sky_only", "nested_checker"))


def _cover(w=24, h=16, depth=10):
    camera = scenes.cam1(w, h)
    scene = scenes.cover_scene(2, 2, camera, z=-0.2, seed=0)
    return scene, camera, RenderConfig(width=w, height=h, max_depth=depth)


def test_pool_size_invariance():
    """The claim order moves paths between lanes, not their draws, which
    key on the work id: the image does not depend on the pool size
    (tests/test_fast_shade.py's tolerance)."""
    scene, camera, cfg = _cover()
    pix = torch.arange(24 * 16)
    a = wavefront._render_fast(scene, camera, pix, cfg, 2, 0, rng.key(3), 256)
    b = wavefront._render_fast(scene, camera, pix, cfg, 2, 0, rng.key(3), 4096)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    c = wavefront._render_generic(scene, camera, pix, cfg, 2, 0, rng.key(3), 64)
    np.testing.assert_allclose(c.numpy(), b.numpy(), **TOL)


def test_fast_matches_generic_and_megakernel():
    """Within the port: the fast path against the generic path and against
    K1's plain version, all three on the same hash streams."""
    scene, camera, cfg = _cover()
    pix = torch.arange(24 * 16)
    wavefront.COUNTS.update(iterations=0, segments=0)
    fast = wavefront._render_fast(scene, camera, pix, cfg, 4, 0, rng.key(0)).numpy()
    counts = dict(wavefront.COUNTS)
    assert counts["iterations"] > cfg.max_depth // 2 and counts["segments"] >= 24 * 16 * 4
    gen = wavefront._render_generic(scene, camera, pix, cfg, 4, 0, rng.key(0)).numpy()
    mega = megakernel.render_megakernel_plain(scene, camera, cfg, 4, 0, rng.key_seed(rng.key(0)))
    np.testing.assert_allclose(fast, gen, **TOL)
    np.testing.assert_allclose(fast, mega.numpy(), **TOL)


def test_prim_nearest_hook():
    """The fast path takes its K3 as an argument, so the same frame can run
    on K3's plain version; on the CPU the wrapper runs that version."""
    scene, camera, cfg = _cover(16, 12, 6)
    pix = torch.arange(16 * 12)
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return prim_ops.prim_nearest_shaded_plain(*args)

    a = wavefront.render_wavefront(scene, camera, pix, cfg, 2, 0, rng.key(1))
    b = wavefront.render_wavefront(scene, camera, pix, cfg, 2, 0, rng.key(1), prim_nearest=spy)
    assert torch.equal(a, b) and calls and all(s == (8, 512) for s in calls)


def test_shade_bounce_depth_and_params():
    """shade_bounce with an int depth (the gradient path's call) is bit for
    bit the same as with that depth per lane, and as with the winners'
    columns handed in by K3's plain version."""
    scene, _, cfg = _cover()
    rs = np.random.default_rng(4)
    rays = torch.zeros((8, 512))
    rays[0:3] = torch.from_numpy(rs.uniform(-2, 2, (3, 512)).astype(np.float32))
    rays[3:6] = torch.from_numpy(rs.normal(size=(3, 512)).astype(np.float32))
    t, prim, params = prim_ops.prim_nearest_shaded(rays, scene.sph_packed, scene.tri_packed,
                                                   scene.shade_table, scene.num_spheres,
                                                   cfg.t_min, cfg.t_max)
    work = torch.arange(512)
    base = fast_shade.shade_bounce(scene, rays, t, prim, 9, work, 3, cfg)
    per_lane = fast_shade.shade_bounce(scene, rays, t, prim, 9, work, torch.full((512,), 3), cfg)
    fetched = fast_shade.shade_bounce(scene, rays, t, prim, 9, work, 3, cfg, params=params)
    assert base["hit"].any() and (~base["hit"]).any()
    for other in (per_lane, fetched):
        for k, v in base.items():
            vs = v if isinstance(v, tuple) else (v,)
            ws = other[k] if isinstance(other[k], tuple) else (other[k],)
            assert all(torch.equal(x, y) for x, y in zip(vs, ws)), k
    mixed = fast_shade.shade_bounce(scene, rays, t, prim, 9, work, work % 5, cfg)
    assert not torch.equal(mixed["new_rays"], base["new_rays"])


def test_render_pixel_colors_routes():
    """renderer "wavefront" is the wavefront; "auto" is K1 where eligible
    and the wavefront otherwise; "megakernel" raises where K1 is not
    eligible; anything else raises."""
    scene, camera, cfg = _cover(16, 12, 6)
    key = rng.key(2)
    pix = torch.arange(16 * 12, dtype=torch.int32)
    wf = render_pixel_colors(scene, camera, cfg.replace(renderer="wavefront"), device="cpu",
                             spp=2, key=key)
    assert torch.equal(wf.reshape(-1, 3),
                       wavefront.render_wavefront(scene, camera, pix, cfg, 2, 0, key))
    auto = render_pixel_colors(scene, camera, cfg, device="cpu", spp=2, key=key)
    assert torch.equal(auto.reshape(-1, 3),
                       megakernel.render_megakernel(scene, camera, cfg, 2, 0, rng.key_seed(key)))
    nested = _nested_checker(SceneBuilder)
    assert not megakernel.eligible(nested, cfg)
    img = render_pixel_colors(nested, camera, cfg, device="cpu", spp=1, key=key)
    assert torch.equal(img.reshape(-1, 3),
                       wavefront._render_generic(nested, camera, pix, cfg, 1, 0, key))
    with pytest.raises(NotImplementedError):
        render_pixel_colors(nested, camera, cfg.replace(renderer="megakernel"), device="cpu")
    with pytest.raises(ValueError, match="unknown renderer"):
        render_pixel_colors(scene, camera, cfg.replace(renderer="bogus"), device="cpu")
