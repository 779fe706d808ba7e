"""The chunked and gradient paths of the port against the JAX package.

Inputs come from seeded numpy generators and the scene builders of both
packages (tables bit-equal, test_torch_scene.py).  Tolerances:
- keys: ``rng.key``, ``fold_in`` and ``key_seed`` bit for bit, since every
  hash seed of a frame derives from them;
- images (``render_chunk``, ``render_pixel_colors(wavefront=False)``):
  atol 1e-3, rtol 1e-3 on every value, the JAX package's own render
  parity tolerance (tests/test_megakernel.py);
- ``pixel_grad`` against JAX ``pixel_grad`` with K2 in interpret mode:
  loss at rtol 1e-5, and every leaf at |d| <= 1e-3 |ref| + 1e-3 max|ref|.
  That holds at 1 spp, the spp of test_grad.py's pixel_grad test.  At
  2 spp one path of test_grad.py's scene grazes the critical angle in the
  glass sphere, where d/dx sqrt(x) amplifies the last bits: float32
  rounding alone moves the glass fuzz gradient by 1.3% there (the port in
  float32 against float64), so that draw cannot test parity;
- the port's autograd against its own central finite differences on
  test_grad.py's eight cases, at that file's tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu import grad as jgrad
from rt_tpu import pallas_ops
from rt_tpu import scenes as jscenes
from rt_tpu.config import CompatConfig as JCompat
from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.render import render_chunk as j_render_chunk
from rt_tpu.render import render_pixel_colors as j_render_pixel_colors
from rt_tpu.scene import SceneBuilder as JBuilder
from rt_tpu_torch import convert, grad, rng, scenes
from rt_tpu_torch.config import CompatConfig, RenderConfig
from rt_tpu_torch.render import render_chunk, render_pixel_colors
from rt_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)

TOL = dict(atol=1e-3, rtol=1e-3)
W, H = 24, 16


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, -1, 2**32 + 5])
@pytest.mark.parametrize("data", [0, 0xCA0, 0x7ACE, 90_000, 2**31 + 3, 2**32 - 1])
def test_keys_bit_exact(seed, data):
    ref = jax.random.key(seed)
    np.testing.assert_array_equal(rng.key(seed), np.asarray(jax.random.key_data(ref)))
    folded = jax.random.fold_in(ref, data)
    got = rng.fold_in(rng.key(seed), data)
    np.testing.assert_array_equal(got, np.asarray(jax.random.key_data(folded)))
    assert rng.key_seed(got) == int(np.asarray(jax.random.key_data(folded))[-1])


# -- the chunked forward path ---------------------------------------------------


@pytest.fixture(scope="module")
def cover():
    """cover_scene(4, 4) through cam1 at 32x24 in both packages."""
    jcam, tcam = jscenes.cam1(32, 24), scenes.cam1(32, 24)
    jscene = jscenes.cover_scene(4, 4, jcam, z=-0.2, seed=0)
    tscene = scenes.cover_scene(4, 4, tcam, z=-0.2, seed=0)
    return jscene, jcam, tscene, tcam


def test_render_chunk_matches_jax_on_a_crop(cover):
    """A 16x10 crop of the frame (ground checker, glass, metal and the
    image-textured sphere), 2 spp from sample 3, forward only."""
    jscene, jcam, tscene, tcam = cover
    ys, xs = np.meshgrid(np.arange(6, 16), np.arange(8, 24), indexing="ij")
    pix = (ys * 32 + xs).reshape(-1).astype(np.int32)
    jcfg = JConfig(width=32, height=24, max_depth=12)
    tcfg = RenderConfig(width=32, height=24, max_depth=12)
    ref = np.asarray(j_render_chunk(jscene, jcam, jnp.asarray(pix), jcfg, 2, jnp.int32(3),
                                    jax.random.key(4)))
    got = render_chunk(tscene, tcam, torch.from_numpy(pix), tcfg, 2, 3, rng.key(4))
    assert got.shape == (pix.size, 3) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert np.abs(ref).max() > 0.05


def test_render_pixel_colors_chunked_matches_jax(cover):
    """wavefront=False over three chunks of 160 pixels (the last one 64
    pixels, padded), each under its own folded key."""
    jscene, jcam, tscene, tcam = cover
    jcam, tcam = jscenes.cam1(W, H), scenes.cam1(W, H)
    jcfg = JConfig(width=W, height=H, max_depth=10, max_rays_per_batch=320)
    tcfg = RenderConfig(width=W, height=H, max_depth=10, max_rays_per_batch=320)
    ref = np.asarray(j_render_pixel_colors(jscene, jcam, jcfg, spp=2, key=jax.random.key(2),
                                           wavefront=False))
    got = render_pixel_colors(tscene, tcam, tcfg, device="cpu", spp=2, key=rng.key(2),
                              wavefront=False)
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # One chunk over the whole frame draws other keys: not the same image.
    whole = render_pixel_colors(tscene, tcam, tcfg.replace(max_rays_per_batch=1 << 20),
                                device="cpu", spp=2, key=rng.key(2), wavefront=False)
    assert not torch.equal(whole, got)


def test_defocus_camera_raises_on_the_chunked_path():
    """A defocused camera on the chunked path.  It raised while the port
    could not draw jax.random's thin-lens disc; it now draws it
    (sampling.random_in_unit_disc) and matches the JAX package's
    render_chunk."""
    jcam, tcam = jscenes.cam2(8, 6), scenes.cam2(8, 6)
    assert tcam.defocus_on
    pix = np.arange(0, 48, 2, dtype=np.int32)
    jcfg, tcfg = JConfig(width=8, height=6, max_depth=6), RenderConfig(width=8, height=6, max_depth=6)
    ref = np.asarray(j_render_chunk(jscenes.gen_checkered(), jcam, jnp.asarray(pix), jcfg, 2,
                                    jnp.int32(0), jax.random.key(0)))
    got = render_chunk(scenes.gen_checkered(), tcam, torch.from_numpy(pix), tcfg, 2, 0, rng.key(0))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


# -- gradients --------------------------------------------------------------------


def _grad_scene(builder):
    """tests/test_grad.py's scene: lambertian, metal, glass and an
    image-textured sphere in cam1's view."""
    b = builder()
    lam = b.lambertian_rgb(0.8, 0.5, 0.3)
    metal = b.metal_solid((0.7, 0.6, 0.5), 0.1)
    glass = b.dielectric(1.5)
    img = np.linspace(0.6, 1.0, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    textured = b.lambertian(b.image_texture(img))
    b.add_sphere((-0.6, 0.4, 0.0), 0.7, lam)
    b.add_sphere((0.7, -0.3, 0.1), 0.6, metal)
    b.add_sphere((1.4, -1.5, 0.2), 0.5, glass)
    b.add_sphere((-1.3, -0.9, 0.0), 0.5, textured)
    return b.build(use_bvh=False)


def _gray_scene(builder):
    """Gray albedos only: every Russian-roulette max ties across channels,
    and the white sphere's probability ties the clamp at 1."""
    b = builder()
    ground = b.lambertian(b.checker(0.5, b.solid_color((0.2, 0.2, 0.2)),
                                   b.solid_color((0.9, 0.9, 0.9))))
    b.add_sphere((0.0, 0.0, -1000.7), 1000.0, ground)
    b.add_sphere((-0.6, 0.4, 0.0), 0.7, b.lambertian_rgb(0.5, 0.5, 0.5))
    b.add_sphere((0.7, -0.3, 0.1), 0.6, b.metal_solid((0.6, 0.6, 0.6), 0.3))
    b.add_sphere((1.3, -1.4, 0.1), 0.5, b.lambertian_rgb(1.0, 1.0, 1.0))
    return b.build(use_bvh=False)


CASES = {  # name: (scene factory, compat overrides)
    "test_grad_scene": (_grad_scene, dict(rr_clamp=0.6)),
    "gray_ties": (_gray_scene, {}),
}


def _configs(compat):
    kw = dict(width=W, height=H, diff_max_depth=4, detach_sampling=False)
    return JConfig(**kw, compat=JCompat(**compat)), RenderConfig(**kw, compat=CompatConfig(**compat))


@pytest.fixture(scope="module")
def jax_grads():
    """JAX pixel_grad at 1 spp on each case, with K2 (pallas_ops.
    sphere_nearest) in interpret mode as the TPU path runs it."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax.clear_caches()
        mp.setattr(pallas_ops, "available", lambda: True)
        mp.setattr(pallas_ops, "sphere_nearest",
                   functools.partial(pallas_ops.sphere_nearest, interpret=True))
        for name, (factory, compat) in CASES.items():
            jcfg, _ = _configs(compat)
            loss, g = jgrad.pixel_grad(factory(JBuilder), jscenes.cam1(W, H), jcfg,
                                       jnp.arange(W * H, dtype=jnp.int32),
                                       jnp.zeros((W * H, 3), jnp.float32), jax.random.key(0), spp=1)
            out[name] = (float(loss), jax.tree.map(np.asarray, g))
        jax.clear_caches()
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_pixel_grad_matches_jax(jax_grads, name):
    factory, compat = CASES[name]
    _, tcfg = _configs(compat)
    scene = factory(SceneBuilder)
    tex_before = scene.tex_color.clone()
    loss, g = grad.pixel_grad(scene, scenes.cam1(W, H), tcfg, torch.arange(W * H),
                              torch.zeros((W * H, 3)), rng.key(0), spp=1)
    ref_loss, ref = jax_grads[name]
    assert loss.item() == pytest.approx(ref_loss, rel=1e-5)
    ref = convert.params_from_arrays(ref)
    for leaf in grad.SceneParams._fields:
        got, want = getattr(g, leaf), getattr(ref, leaf)
        assert got.shape == want.shape, leaf
        bound = 1e-3 * want.abs() + 1e-3 * want.abs().max()
        assert bool(((got - want).abs() <= bound).all()), (leaf, got, want)
    assert g.tex_color.abs().max() > 0 and torch.equal(scene.tex_color, tex_before)
    if name == "gray_ties":
        assert g.atlas.abs().max() == 0  # no image texture: the leaf is unused


@pytest.fixture(scope="module")
def fd_setup():
    """tests/test_grad.py's FD setup in the port: rr_clamp=0.6 pins the
    Russian-roulette probability, so with frozen keys the per-sample loss
    is a smooth function of the parameters; loss at 2 spp."""
    scene = _grad_scene(SceneBuilder)
    camera = scenes.cam1(W, H)
    _, cfg = _configs(dict(rr_clamp=0.6))
    pix, target, key = torch.arange(W * H), torch.zeros((W * H, 3)), rng.key(0)
    loss_fn = lambda p: grad.pixel_loss(p, scene, camera, cfg, pix, target, key, spp=2)
    _, ad = grad.pixel_grad(scene, camera, cfg, pix, target, key, spp=2)
    return loss_fn, grad.get_params(scene), ad


@pytest.mark.parametrize(
    "leaf,index,eps,tol",
    [  # tests/test_grad.py's cases and tolerances
        ("tex_color", (0, 0), 1e-2, 0.08),
        ("tex_color", (1, 1), 1e-2, 0.08),
        ("sky_exposure", (), 1e-2, 0.08),
        ("sky_turbidity", (), 1e-2, 0.12),
        ("mat_fuzz", (1,), 1e-2, 0.15),
        ("mat_ior", (2,), 1e-4, 0.20),
        ("sky_sun_direction", (0,), 1e-2, 0.12),
        ("atlas", None, 1e-2, 0.1),  # the texel with the largest AD gradient
    ],
)
def test_grad_matches_finite_difference(fd_setup, leaf, index, eps, tol):
    loss_fn, params, ad_params = fd_setup
    g = getattr(ad_params, leaf)
    if index is None:
        assert g.abs().max() > 0, "no atlas gradient: textured sphere unhit?"
        index = tuple(int(i) for i in np.unravel_index(int(g.abs().argmax()), g.shape))
    ad = float(g[index])
    fd = grad.finite_difference_grad(loss_fn, params, leaf, index, eps)
    assert abs(fd) > 1e-6, (leaf, index, "FD gradient vanished")
    scale = max(abs(ad), abs(fd), 1e-4)
    assert abs(ad - fd) / scale < tol, (leaf, index, ad, fd)


def test_set_params_shares_tables_and_keeps_the_scene():
    scene = _grad_scene(SceneBuilder)
    p = grad.get_params(scene)
    bumped = p._replace(tex_color=p.tex_color + 1.0, sky_exposure=p.sky_exposure * 2)
    s2 = grad.set_params(scene, bumped)
    assert s2 is not scene and s2.shade_table is scene.shade_table and s2.atlas is scene.atlas
    assert torch.equal(s2.tex_color, p.tex_color + 1.0)
    assert float(s2.sky.exposure) == 2 * float(scene.sky.exposure)
    assert s2.sky.hw_params is scene.sky.hw_params
    assert not torch.equal(scene.tex_color, s2.tex_color)
