"""examples/inverse_rendering_torch.py against examples/inverse_rendering.py
on the CPU: the first 5 steps of the fit.  Serial CPU time: about 20 s.

The JAX side is the JAX example's own loop (its scene, camera, cfg, key,
perturbation and ``optax.adam(5e-2)``), written out here because the
example prints rounded values only.  Tolerances, tests/test_torch_grad.py's:
the loss before each step at rtol 1e-5, and the albedo after each step at
|d| <= 1e-3 |ref| + 1e-3 max|ref|.  optax and ``torch.optim.Adam`` compute
the same update in another order of operations, so the comparison covers
the first steps only, before the roundings can compound.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rt_tpu import grad as jgrad
from rt_tpu import scenes as jscenes
from rt_tpu.config import CompatConfig as JCompat
from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.render import render_chunk as j_render_chunk
from rt_tpu.scene import SceneBuilder as JBuilder

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5


def _example():
    path = os.path.join(REPO, "examples", "inverse_rendering_torch.py")
    spec = importlib.util.spec_from_file_location("inverse_rendering_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_fit(steps: int):
    """examples/inverse_rendering.py's fit: (losses, albedo after each step)."""
    b = JBuilder()
    lam = b.lambertian_rgb(0.75, 0.25, 0.2)
    metal = b.metal_solid((0.7, 0.6, 0.5), 0.15)
    b.add_sphere((-0.6, 0.4, 0.0), 0.7, lam)
    b.add_sphere((0.7, -0.3, 0.1), 0.6, metal)
    scene = b.build(use_bvh=False)
    camera = jscenes.cam1(48, 32)
    cfg = JConfig(width=48, height=32, diff_max_depth=4, detach_sampling=False,
                  compat=JCompat(rr_clamp=0.6))
    pixel_idx = jnp.arange(48 * 32, dtype=jnp.int32)
    key = jax.random.key(0)
    true_params = jgrad.get_params(scene)
    target = j_render_chunk(scene, camera, pixel_idx, cfg, 4, jnp.int32(0), key,
                            differentiable=True)
    params = true_params._replace(
        tex_color=true_params.tex_color.at[0].set(jnp.array([0.2, 0.7, 0.7])),
        sky_exposure=true_params.sky_exposure * 1.8,
    )
    opt = optax.adam(5e-2)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: jgrad.pixel_loss(p, scene, camera, cfg, pixel_idx, target, key, 4))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses, albedos = [], []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
        albedos.append(np.asarray(params.tex_color[0]))
    return losses, albedos


@pytest.fixture(scope="module")
def fits():
    return _example().run(STEPS, device="cpu", log=lambda line: None), _jax_fit(STEPS)


def test_losses_match_jax(fits):
    got, (losses, _) = fits
    assert len(got["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=0)
    assert got["losses"][-1] < got["losses"][0]


def test_albedo_matches_jax(fits):
    got, (_, albedos) = fits
    for step, (a, r) in enumerate(zip(got["albedos"], albedos)):
        bound = 1e-3 * np.abs(r) + 1e-3 * np.abs(r).max()
        assert (np.abs(a - r) <= bound).all(), (step, a, r)
    # The fit moves the albedo from (0.2, 0.7, 0.7) toward the truth.
    np.testing.assert_allclose(got["truth"], [0.75, 0.25, 0.2], rtol=1e-6)
    assert np.abs(got["albedos"][-1] - got["truth"]).max() < 0.5 - 1e-3


def test_example_cli_writes_pngs(tmp_path):
    from rt_tpu_torch.io.png_io import decode_png

    assert _example().main(["--steps", "1", "--device", "cpu", "--out", str(tmp_path)]) == 0
    for name in ("target.png", "recovered.png"):
        with open(tmp_path / name, "rb") as f:
            assert decode_png(f.read()).shape == (32, 48, 3)
