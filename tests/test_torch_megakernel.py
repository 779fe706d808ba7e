"""The port's flat megakernel against the JAX package's readable reference.

``render_megakernel_plain`` (the plain PyTorch version of the CUDA kernel)
must render what ``rt_tpu.wavefront._render_generic`` renders for every
scene of tests/test_megakernel.py, at that file's tolerance, atol 1e-3 and
rtol 1e-3: both draw from the same counter-hash streams keyed on the global
(sample, pixel) work id, so they differ only by f32 rounding (native vs
XLA transcendentals, summation order).  Each side builds the scene with its
own SceneBuilder (tables bit-equal, test_torch_scene.py).

The CUDA kernel itself is held against the plain version by the ``cuda``
test below, which runs only where a card is present.  ``rt_tpu`` is
imported only where the JAX side is built, so that the ``cuda`` test also
runs on a machine without the JAX package's dependencies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu_torch import megakernel
from rt_tpu_torch.camera import make_camera
from rt_tpu_torch.config import CompatConfig, RenderConfig
from rt_tpu_torch.scene import SceneBuilder
from rt_tpu_torch.sky import SkyParams

torch.set_num_threads(2)

W, H = 32, 24
TOL = dict(atol=1e-3, rtol=1e-3)

# name: (extra primitive, defocus angle, compat overrides, sky)
CASES = {
    "lambertian": (lambda b: b.add_sphere((0, 0, 1), 1, b.lambertian(b.solid_color((0.8, 0.2, 0.1)))), 0.0, {}, "default"),
    "metal": (lambda b: b.add_sphere((0, 0, 1), 1, b.metal(b.solid_color((0.8, 0.7, 0.6)), fuzz=0.2)), 0.0, {}, "default"),
    "dielectric": (lambda b: b.add_sphere((0, 0, 1), 1, b.dielectric(1.5)), 0.0, {}, "default"),
    "frosted": (lambda b: b.add_sphere((0, 0, 1), 1, b.dielectric(1.5, 0.15)), 0.0, {}, "default"),
    "emissive": (lambda b: b.add_sphere((0, 0, 1), 1, b.emissive((3.0, 2.0, 1.0))), 0.0, {}, "default"),
    "triangle": (lambda b: b.add_triangle((-1, -1, 0.5), (2, -1, 0.5), (0, 1, 2.5), b.lambertian(b.solid_color((0.2, 0.4, 0.8)))), 0.0, {}, "default"),
    "defocus": (lambda b: b.add_sphere((0, 0, 1), 1, b.lambertian(b.solid_color((0.7, 0.3, 0.2)))), 0.6, {}, "default"),
    "scrambled_jitter": (lambda b: b.add_sphere((0, 0, 1), 1, b.lambertian(b.solid_color((0.6, 0.6, 0.2)))), 0.0, {"shared_halton_jitter": False}, "default"),
    "quirk_sky": (lambda b: b.add_sphere((0, 0, 1), 1, b.lambertian(b.solid_color((0.6, 0.2, 0.6)))), 0.0, {}, "quirk"),
    "hosek_sky": (lambda b: b.add_sphere((0, 0, 1), 1, b.lambertian(b.solid_color((0.5, 0.4, 0.3)))), 0.0, {}, "hosek"),
}


def _sky(mod, kind):
    if kind == "hosek":
        return mod.hosek_reference()
    sky = mod.default()
    return sky.replace(cos_gamma_as_angle=True) if kind == "quirk" else sky


def _case(name, builder, make, sky_mod, cfg_cls, compat_cls):
    """(scene, camera, cfg) of one case, built with one package's classes."""
    mat_fn, defocus, compat, sky_kind = CASES[name]
    b = builder()
    b.add_sphere((0, 0, -1000), 1000, b.lambertian(b.solid_color((0.5, 0.5, 0.5))))
    mat_fn(b)
    scene = b.build(sky=_sky(sky_mod, sky_kind))
    camera = make((6, 0, 2), (0, 0, 1), (0, 0, 1), focus_distance=6.0, defocus_angle=defocus,
                  image_width=W, image_height=H, vertical_fov=30.0)
    cfg = cfg_cls(width=W, height=H, samples_per_pixel=2, max_depth=8, compat=compat_cls(**compat))
    return scene, camera, cfg


def _port_case(name):
    return _case(name, SceneBuilder, make_camera, SkyParams, RenderConfig, CompatConfig)


def _pair(name):
    """(JAX scene, camera, cfg) and (port scene, camera, cfg) of one case."""
    from rt_tpu.camera import make_camera as j_make_camera
    from rt_tpu.config import CompatConfig as JCompat
    from rt_tpu.config import RenderConfig as JConfig
    from rt_tpu.scene import SceneBuilder as JBuilder
    from rt_tpu.sky import SkyParams as JSky

    return _case(name, JBuilder, j_make_camera, JSky, JConfig, JCompat), _port_case(name)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_megakernel_matches_generic(name):
    from rt_tpu.wavefront import _render_generic

    (js, jc, jcfg), (ts, tc, tcfg) = _pair(name)
    assert megakernel.eligible(ts, tcfg)
    ref = np.asarray(_render_generic(
        js, jc, jnp.arange(W * H, dtype=jnp.int32), jcfg, 2, jnp.int32(0), jax.random.key(jcfg.seed)))
    got = megakernel.render_megakernel(ts, tc, tcfg, 2, 0, tcfg.seed).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(ref).max() > 0.05  # the frame is not trivially dark


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(monkeypatch):
    """Hand-written CUDA kernel against its plain version on the card, on
    every case above (defocus among them), the whole frame and a pixel range
    with a sample offset, bit for bit, with the scratch cap lowered to two
    samples of the whole frame: the ring then holds 307 of the frame's 768
    pixels at 5 spp and 170 of the range's 384 at 9 spp, three generations
    of each slot, and lanes wait for them (each lane claims an item at
    once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    monkeypatch.setattr(megakernel, "SCRATCH_CAP", 12 * W * H * 2)
    waits = 0
    for name in CASES:
        scene, camera, cfg = _port_case(name)
        scene.to("cuda")
        for spp, off, base, n in ((2, 0, 0, None), (5, 0, 0, None), (3, 3, W * H // 2, W * H // 2),
                                  (9, 3, W * H // 2, W * H // 2)):
            before = megakernel.LAUNCHES
            got = megakernel.render_megakernel(scene, camera, cfg, spp, off, 0, pixel_base=base,
                                               n_pixels=n)
            assert megakernel.LAUNCHES == before + 1
            ring = megakernel.K1_RING
            assert ring["launches"] == 1
            assert ring["generations"] == (3 if spp in (5, 9) else 1), (name, spp, ring)
            waits += int(ring["waits"])
            ref = megakernel.render_megakernel_plain(scene, camera, cfg, spp, off, 0,
                                                     pixel_base=base, n_pixels=n)
            assert torch.equal(got, ref), (name, spp, off, base)
    assert waits > 0


@pytest.mark.cuda
def test_cuda_kernel_repeats_bit_identical():
    """Two K1 launches of the same frame give the same image bit for bit,
    whichever lanes claim which (pixel, sample) items."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    scene, camera, cfg = _port_case("dielectric")
    scene.to("cuda")
    a = megakernel.render_megakernel(scene, camera, cfg, 16, 0, 0)
    b = megakernel.render_megakernel(scene, camera, cfg, 16, 0, 0)
    assert torch.equal(a, b) and a.abs().max() > 0.05
