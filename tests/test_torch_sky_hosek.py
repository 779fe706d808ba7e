"""The live Hosek-Wilkie sky of the port (``sky.hosek_config``,
``SkyParams.hosek``) against the JAX package's (rt_tpu/sky.py) on the CPU.

Tolerances:
- ``hosek_config`` on a grid of turbidity {0.5, 1, 1.5, 3, 7.3, 10, 12},
  albedo {0, 0.3, 1} and elevation {0, 0.05, 0.3, 0.8, 1.2, pi/2} (the
  values outside the grid's domain test the clipping): atol 1e-6, rtol
  1e-5;
- its gradients in all three arguments against ``jax.grad``, at points
  off the knots and the clip boundaries (where JAX splits a tie's
  gradient): rtol 1e-4;
- ``sky_color_toward`` on 4,096 seeded unit directions: rtol 1e-5;
- K1's plain version on a cover crop under ``hosek(3.0, 0.3, 0.8)``
  against JAX's flat megakernel in interpret mode: atol 1e-3, rtol 1e-3,
  the JAX package's megakernel parity tolerance.

Serial CPU time of this file: about 16 s.
"""

import filecmp
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu import scenes as jscenes
from rt_tpu import sky as jsky
from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.megakernel import render_megakernel as j_render_megakernel
from rt_tpu_torch import megakernel, scenes, sky
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.sky import SkyParams

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURBIDITY = (0.5, 1.0, 1.5, 3.0, 7.3, 10.0, 12.0)
ALBEDO = (0.0, 0.3, 1.0)
ELEVATION = (0.0, 0.05, 0.3, 0.8, 1.2, math.pi / 2)
# (turbidity, albedo, elevation, exposure): config 4's and config 5's skies
# and one with the sun off the zenith (elevation from the sun).
SKIES = {
    "config4": dict(turbidity=3.0, albedo=0.3, elevation=0.8),
    "config5": dict(turbidity=8.0, albedo=0.1, elevation=0.07, exposure=0.35),
    "tilted_sun": dict(turbidity=2.5, albedo=0.6, sun_direction=(0.3, -0.4, 0.5), exposure=0.8),
}


def test_dataset_copy_is_byte_equal():
    assert filecmp.cmp(os.path.join(REPO, "rt_tpu", "data", "hw_dataset.npz"),
                       os.path.join(REPO, "rt_tpu_torch", "data", "hw_dataset.npz"), shallow=False)


@pytest.mark.parametrize("turbidity", TURBIDITY)
def test_hosek_config_matches_jax(turbidity):
    for albedo in ALBEDO:
        for elevation in ELEVATION:
            ref = np.asarray(jsky.hosek_config(turbidity, albedo, elevation))
            got = sky.hosek_config(turbidity, albedo, elevation)
            assert got.dtype == torch.float32 and got.shape == (3, 10)
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-5,
                                       err_msg=f"{turbidity}, {albedo}, {elevation}")


@pytest.mark.parametrize("point", [(3.0, 0.3, 0.8), (7.3, 0.6, 0.3), (1.5, 0.1, 1.2),
                                   (12.0, 0.5, 0.5), (0.5, 0.7, 0.05)])
def test_hosek_config_gradients_match_jax(point):
    """d/d(turbidity, albedo, elevation) of a weighted sum of the
    configuration; turbidity 12 and 0.5 lie outside the grid, where the
    clip gives both packages a zero turbidity gradient."""
    weights = np.random.default_rng(0).normal(size=(3, 10)).astype(np.float32)
    ref = jax.grad(lambda t, a, e: jnp.sum(jsky.hosek_config(t, a, e) * weights),
                   argnums=(0, 1, 2))(*(jnp.float32(v) for v in point))
    leaves = [torch.tensor(v, requires_grad=True) for v in point]
    (sky.hosek_config(*leaves) * torch.from_numpy(weights)).sum().backward()
    for leaf, want in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.item(), float(want), rtol=1e-4, atol=0)
    assert any(abs(float(r)) > 1.0 for r in ref)


@pytest.mark.parametrize("name", list(SKIES))
def test_sky_color_toward_matches_jax(name):
    dirs = np.random.default_rng(5).normal(size=(4096, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ref = np.asarray(jsky.sky_color_toward(jsky.SkyParams.hosek(**SKIES[name]), jnp.asarray(dirs)))
    got = sky.sky_color_toward(SkyParams.hosek(**SKIES[name]), torch.from_numpy(dirs)).numpy()
    assert ref.max() > 0.05 and (ref > 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_hosek_without_elevation_matches_jax():
    """``elevation=None`` takes asin of the normalised sun's z; a given
    elevation leaves the sun at +z and moves only the H-W rows."""
    kw = dict(turbidity=4.0, albedo=0.25, sun_direction=(0.6, 0.2, 0.35), exposure=0.5)
    ref, got = jsky.SkyParams.hosek(**kw), SkyParams.hosek(**kw)
    for name in ("sun_direction", "turbidity", "exposure", "hw_params"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-6, rtol=1e-5, err_msg=name)
    assert not got.cos_gamma_as_angle and not ref.cos_gamma_as_angle
    fixed = SkyParams.hosek(elevation=0.07)
    np.testing.assert_array_equal(fixed.sun_direction.numpy(), [0.0, 0.0, 1.0])
    np.testing.assert_array_equal(fixed.hw_params.numpy(), sky.hosek_config(3.0, 0.2, 0.07).numpy())
    assert not torch.equal(fixed.hw_params, SkyParams.hosek().hw_params)


def test_gradients_flow_from_the_sky_into_its_configuration():
    """sky_color_toward under hosek() built from leaves that require grad:
    finite, nonzero gradients in turbidity, albedo and elevation."""
    leaves = [torch.tensor(v, requires_grad=True) for v in (3.0, 0.3, 0.8)]
    params = SkyParams.hosek(*leaves)
    dirs = torch.nn.functional.normalize(torch.tensor([[0.3, 0.1, 0.9], [0.9, 0.0, 0.2]]), dim=1)
    sky.sky_color_toward(params, dirs).sum().backward()
    for leaf in leaves:
        assert leaf.grad is not None and math.isfinite(leaf.grad.item()) and leaf.grad.item() != 0


def test_k1_plain_cover_crop_under_live_sky_matches_jax_interpret():
    """The cover scene in miniature under hosek(3.0, 0.3, 0.8): the frame
    scalars carry the live H-W rows into K1's plain version, held against
    the TPU kernel in interpret mode."""
    w, h = 32, 24
    jcam, tcam = jscenes.cam1(w, h), scenes.cam1(w, h)
    jscene = jscenes.cover_scene(4, 4, jcam, z=-0.2, seed=0).replace(
        sky=jsky.SkyParams.hosek(**SKIES["config4"]))
    tscene = scenes.cover_scene(4, 4, tcam, z=-0.2, seed=0)
    tscene.sky = SkyParams.hosek(**SKIES["config4"])
    jcfg = JConfig(width=w, height=h, samples_per_pixel=2, max_depth=12)
    tcfg = RenderConfig(width=w, height=h, samples_per_pixel=2, max_depth=12)
    ref = np.asarray(j_render_megakernel(
        jscene, jcam, jcfg, 2, 0, jax.random.key(0),
        lanes=256, tile_pixels=256, packed_select=False, interpret=True))
    got = megakernel.render_megakernel(tscene, tcam, tcfg, 2, 0, 0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)
    # The live sky is what the frame shows: it differs from the Perez sky's.
    perez = megakernel.render_megakernel(scenes.cover_scene(4, 4, tcam, z=-0.2, seed=0), tcam,
                                         tcfg, 2, 0, 0).numpy()
    assert np.abs(got - perez).max() > 0.05
