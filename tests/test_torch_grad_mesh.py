"""The chunked and gradient paths on generic scenes (a BVH mesh, and a
scene without a shade table) against the JAX package on the CPU: the
generic bounce step (integrator._bounce_step), the BVH walk, and
``jax.random``'s stream.

The mesh is tests/test_grad_mesh.py's fixture: 324 Lambertian triangles
(above the 256-triangle BVH threshold), cam1 at 16x12, diff_max_depth 3,
2 spp, rr_clamp 0.6, detach_sampling off.  Tolerances:
- ``pixel_grad`` against JAX ``value_and_grad(pixel_loss)``: the loss at
  rtol 1e-5 and every leaf at |d| <= 1e-3 |ref| + 1e-3 max|ref|, the
  tolerance of test_torch_grad.py (the draws are JAX's bit for bit and the
  walk finds the same winners; what remains is float rounding, measured
  at ~1e-7 on this fixture);
- the port's autograd against its own central finite difference at 8%,
  test_grad_mesh.py's tolerance;
- images (``render_pixel_colors(wavefront=False)``): atol 1e-3, rtol 1e-3,
  the render parity tolerance of the other chunked-path tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu import grad as jgrad
from rt_tpu import scenes as jscenes
from rt_tpu.config import CompatConfig as JCompat
from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.render import render_pixel_colors as j_render_pixel_colors
from rt_tpu.scene import SceneBuilder as JBuilder
from rt_tpu_torch import convert, grad, rng, scenes
from rt_tpu_torch.bvh import traverse
from rt_tpu_torch.config import CompatConfig, RenderConfig
from rt_tpu_torch.render import render_pixel_colors
from rt_tpu_torch.scene import SceneBuilder
from rt_tpu_torch.sky import SkyParams

torch.set_num_threads(2)
W, H = 16, 12
TOL = dict(atol=1e-3, rtol=1e-3)


def _mesh_scene(builder):
    """tests/test_grad_mesh.py's blob of 81 jittered tetrahedra."""
    rs = np.random.default_rng(7)
    b = builder()
    mat = b.lambertian_rgb(0.7, 0.4, 0.3)
    tris = []
    for i in range(9):
        for j in range(9):
            base = np.array([(i - 4) * 0.35, (j - 4) * 0.35, 0.0]) + rs.uniform(-0.05, 0.05, 3)
            v = base + np.array([[0, 0, 0], [0.15, 0, 0], [0, 0.15, 0], [0, 0, 0.15]])
            for f in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
                tris.append(v[list(f)])
    b.add_triangles(np.asarray(tris, np.float32), None, mat)
    return b.build()


def _nested_checker(builder):
    """A checker with an image child (no shade table), metal and glass."""
    b = builder()
    img = np.linspace(0.2, 0.9, 4 * 4 * 3, dtype=np.float32).reshape(4, 4, 3)
    ck = b.checker(0.5, b.image_texture(img), b.solid_color((0.9, 0.9, 0.9)))
    b.add_sphere((0, 0, -1000), 1000, b.lambertian(ck))
    b.add_sphere((0, 0, 1), 1, b.metal_solid((0.8, 0.7, 0.6), 0.1))
    b.add_sphere((1.5, -1, 0.6), 0.6, b.lambertian_rgb(0.3, 0.6, 0.4))
    return b.build()


CASES = {  # name: (scene factory, diff_max_depth, spp)
    "mesh": (_mesh_scene, 3, 2),
    "no_shade_table": (_nested_checker, 3, 1),
}


def _cfgs(depth):
    kw = dict(width=W, height=H, diff_max_depth=depth, detach_sampling=False)
    return (JConfig(**kw, compat=JCompat(rr_clamp=0.6)),
            RenderConfig(**kw, compat=CompatConfig(rr_clamp=0.6)))


@pytest.fixture(scope="module")
def jax_grads():
    out = {}
    for name, (factory, depth, spp) in CASES.items():
        jcfg, _ = _cfgs(depth)
        scene = factory(JBuilder)
        loss = lambda p, scene=scene, jcfg=jcfg, spp=spp: jgrad.pixel_loss(
            p, scene, jscenes.cam1(W, H), jcfg, jnp.arange(W * H, dtype=jnp.int32),
            jnp.zeros((W * H, 3), jnp.float32), jax.random.key(0), spp=spp)
        val, g = jax.value_and_grad(loss)(jgrad.get_params(scene))
        out[name] = (float(val), jax.tree.map(np.asarray, g))
    jax.clear_caches()
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_pixel_grad_matches_jax(jax_grads, name):
    factory, depth, spp = CASES[name]
    _, tcfg = _cfgs(depth)
    scene = factory(SceneBuilder)
    assert (scene.bvh is not None) == (name == "mesh") and (scene.shade_table is None) == (
        name == "no_shade_table")
    walks = []

    def counted(*args):
        walks.append(1)
        return traverse.bvh_walk(*args)

    loss, g = grad.pixel_grad(scene, scenes.cam1(W, H), tcfg, torch.arange(W * H),
                              torch.zeros((W * H, 3)), rng.key(0), spp=spp, bvh_walk=counted)
    ref_loss, ref = jax_grads[name]
    assert loss.item() == pytest.approx(ref_loss, rel=1e-5)
    ref = convert.params_from_arrays(ref)
    for leaf in grad.SceneParams._fields:
        got, want = getattr(g, leaf), getattr(ref, leaf)
        assert got.shape == want.shape, leaf
        bound = 1e-3 * want.abs() + 1e-3 * want.abs().max()
        assert bool(((got - want).abs() <= bound).all()), (leaf, got, want)
    assert float(g.tex_color.abs().max()) > 0 and float(g.sky_exposure.abs()) > 0
    # Forward and the checkpointed recompute walk each bounce once.
    assert len(walks) == (2 * (depth + 1) if name == "mesh" else 0)


@pytest.mark.parametrize("sky", ["perez", "hosek", "hosek_live"])
@pytest.mark.parametrize("name", list(CASES))
def test_gradient_graph_stays_on_the_rays_device(name, sky):
    """Every node of pixel_loss's autograd graph runs on the scene's device
    (here ``meta``, standing in for a card, with stand-ins for the walk and
    K2); only the gradient accumulators of the sky's CPU leaves are on the
    CPU.  Autograd runs CPU and CUDA nodes on two threads: a mixed graph
    adds a shared input's contributions in arrival order and may recompute
    a checkpointed bounce on either thread, so two backward passes could
    differ."""
    factory, depth, spp = CASES[name]
    _, tcfg = _cfgs(depth)
    scene = factory(SceneBuilder)
    if sky == "hosek":
        scene.sky = SkyParams.hosek_reference()
    elif sky == "hosek_live":
        scene.sky = SkyParams.hosek(3.0, 0.3, 0.8)
    scene.to("meta")

    def walk(scene, org, dirn, *_):
        n = org.shape[0]
        return torch.zeros(n, device=org.device), torch.zeros(n, dtype=torch.int32,
                                                              device=org.device)

    params = grad.SceneParams(*(leaf.detach().requires_grad_() for leaf in grad.get_params(scene)))
    loss = grad.pixel_loss(params, scene, scenes.cam1(W, H), tcfg,
                           torch.arange(W * H, device="meta"), torch.zeros((W * H, 3), device="meta"),
                           rng.key(0), spp, sphere_nearest=walk, bvh_walk=walk)
    seen, stack, cpu_leaves = set(), [loss.grad_fn], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "AccumulateGrad":
            cpu_leaves += node.variable.device.type == "cpu"
            continue
        devices = {m.device.type for m in node._input_metadata}
        assert devices == {"meta"}, (node.name(), devices)
        stack.extend(fn for fn, _ in node.next_functions)
    assert cpu_leaves == (3 if sky == "perez" else 2)  # a Hosek sky reads no turbidity


def test_mesh_autograd_matches_finite_differences():
    _, tcfg = _cfgs(3)
    scene = _mesh_scene(SceneBuilder)
    camera, pix, target = scenes.cam1(W, H), torch.arange(W * H), torch.zeros((W * H, 3))
    _, g = grad.pixel_grad(scene, camera, tcfg, pix, target, rng.key(0), spp=2)
    loss_fn = lambda p: grad.pixel_loss(p, scene, camera, tcfg, pix, target, rng.key(0), spp=2)
    params = grad.get_params(scene)
    for leaf, index in (("tex_color", (0, 0)), ("sky_exposure", ())):
        ad = float(getattr(g, leaf)[index])
        fd = grad.finite_difference_grad(loss_fn, params, leaf, index, 1e-2)
        assert abs(fd) > 1e-6
        assert abs(ad - fd) / max(abs(ad), abs(fd), 1e-4) < 0.08, (leaf, ad, fd)


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_render_matches_jax(name):
    factory = CASES[name][0]
    jcfg = JConfig(width=W, height=H, max_depth=6, max_rays_per_batch=96)
    tcfg = RenderConfig(width=W, height=H, max_depth=6, max_rays_per_batch=96)
    ref = np.asarray(j_render_pixel_colors(factory(JBuilder), jscenes.cam1(W, H), jcfg, spp=2,
                                           key=jax.random.key(3), wavefront=False))
    got = render_pixel_colors(factory(SceneBuilder), scenes.cam1(W, H), tcfg, device="cpu", spp=2,
                              key=rng.key(3), wavefront=False)
    assert got.shape == (H, W, 3) and float(got.mean()) > 0.05
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
