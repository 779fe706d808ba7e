"""The BVH walk of the port (rt_tpu_torch.bvh.traverse) against the JAX
package's ``nearest_hit_bvh`` (rt_tpu/bvh/traverse.py) on the CPU.

Scenes come from both packages' builders with the same calls (their tables
and trees are bit-equal, test_torch_scene.py); rays from seeded numpy
generators.  Tolerances, as tests/test_bvh.py:105 holds the walk against
brute force: the hit masks equal; t within rtol/atol 2e-4; the primitive
ids equal except where two candidates' t lie within 1e-5 relative (XLA:CPU
may fuse the JAX side's products into FMAs, which can reorder near-equal
candidates).  test_torch_walk_probe_cuda.py holds the walk kernel
(csrc/bvh_walk.cu) against the plain walk on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu import scenes as jscenes
from rt_tpu.bvh.traverse import nearest_hit_bvh as j_nearest_hit_bvh
from rt_tpu.config import CompatConfig as JCompat
from rt_tpu.geometry import nearest_hit as j_nearest_hit
from rt_tpu.scene import SceneBuilder as JBuilder
from rt_tpu_torch import scenes as tscenes
from rt_tpu_torch.bvh import traverse
from rt_tpu_torch.config import CompatConfig
from rt_tpu_torch.geometry import nearest_hit
from rt_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)


def _spheres(builder):
    rs = np.random.default_rng(7)
    b = builder()
    m = b.lambertian_rgb(0.5, 0.5, 0.5)
    for _ in range(300):
        b.add_sphere(rs.uniform(-8, 8, 3), rs.uniform(0.2, 1.0), m)
    return b.build(use_bvh=True)


def _triangles(builder):
    rs = np.random.default_rng(8)
    b = builder()
    m = b.lambertian_rgb(0.5, 0.5, 0.5)
    for _ in range(200):
        base = rs.uniform(-5, 5, 3)
        b.add_triangle(base, base + rs.normal(size=3), base + rs.normal(size=3), m)
    b.add_sphere((0.0, 0.0, 0.0), 1.5, m)  # a sphere among the triangles
    return b.build(use_bvh=True)


@pytest.fixture(scope="module")
def mesh_path(tmp_path_factory):
    from tools.gen_fixtures import make_obj_mesh

    path = tmp_path_factory.mktemp("bvh") / "blob.obj"
    assert make_obj_mesh(str(path), res=12) == 264
    return str(path)


def _scenes(name, mesh_path):
    if name == "spheres":
        return _spheres(JBuilder), _spheres(SceneBuilder), 12.0
    if name == "triangles":
        return _triangles(JBuilder), _triangles(SceneBuilder), 8.0
    return jscenes.mesh_with_area_light(mesh_path), tscenes.mesh_with_area_light(mesh_path), 3.0


def _rays(n, extent, seed):
    rs = np.random.default_rng(seed)
    org = rs.uniform(-extent, extent, (n, 3)).astype(np.float32)
    dirn = rs.normal(size=(n, 3)).astype(np.float32)
    return org, dirn


def _check_prims(ts, p_got, p_ref, t_got, org, dirn):
    """Primitive ids equal, except where the two candidates' t agree within
    1e-5 relative."""
    differ = np.nonzero(p_got != p_ref)[0]
    if differ.size:
        o, d = torch.from_numpy(org[differ]), torch.from_numpy(dirn[differ])
        t_ref_prim = traverse._prim_t(ts, torch.from_numpy(p_ref[differ]), o, d, 1e-3, 3e38,
                                      CompatConfig()).numpy()
        np.testing.assert_allclose(t_ref_prim, t_got[differ], rtol=1e-5)
    return differ.size


@pytest.mark.parametrize("name", ["spheres", "triangles", "mesh"])
def test_plain_walk_matches_jax(name, mesh_path):
    js, ts, extent = _scenes(name, mesh_path)
    assert js.bvh is not None and ts.bvh is not None
    org, dirn = _rays(512, extent, 1)
    t_ref, p_ref = (np.asarray(x) for x in j_nearest_hit_bvh(
        js, jnp.asarray(org), jnp.asarray(dirn), 1e-3, 3e38, JCompat()))
    t_got, p_got = traverse.bvh_walk(ts, torch.from_numpy(org), torch.from_numpy(dirn), 1e-3,
                                     3e38, CompatConfig())
    t_got, p_got = t_got.numpy(), p_got.numpy()
    hit = p_ref >= 0
    assert hit.sum() > 50
    np.testing.assert_array_equal(p_got >= 0, hit)
    np.testing.assert_array_equal(t_got[~hit], np.float32(3e38))
    np.testing.assert_allclose(t_got[hit], t_ref[hit], rtol=2e-4, atol=2e-4)
    assert _check_prims(ts, p_got, p_ref, t_got, org, dirn) <= 2


def test_walk_honors_t_max_and_culling(mesh_path):
    js, ts, _ = _scenes("mesh", mesh_path)
    org, dirn = _rays(256, 3.0, 2)
    for t_max, cull in ((2.5, True), (3e38, False)):
        t_ref, p_ref = (np.asarray(x) for x in j_nearest_hit_bvh(
            js, jnp.asarray(org), jnp.asarray(dirn), 1e-3, t_max,
            JCompat(triangle_backface_cull=cull)))
        t_got, p_got = traverse.bvh_walk(ts, torch.from_numpy(org), torch.from_numpy(dirn), 1e-3,
                                         t_max, CompatConfig(triangle_backface_cull=cull))
        hit = p_ref >= 0
        np.testing.assert_array_equal(p_got.numpy() >= 0, hit)
        np.testing.assert_allclose(t_got.numpy()[hit], t_ref[hit], rtol=2e-4, atol=2e-4)
        assert (t_got.numpy()[hit] < t_max).all()


def test_nearest_hit_walks_the_bvh_for_every_impl(mesh_path):
    js, ts, _ = _scenes("mesh", mesh_path)
    org, dirn = _rays(256, 3.0, 3)
    ref = j_nearest_hit(js, jnp.asarray(org), jnp.asarray(dirn), 1e-3, 3e38, JCompat())
    calls = []

    def counted(*args):
        calls.append(1)
        return traverse.bvh_walk_plain(*args)

    for impl in ("auto", "pallas", "detached"):
        rec = nearest_hit(ts, torch.from_numpy(org), torch.from_numpy(dirn), 1e-3, 3e38,
                          CompatConfig(), impl=impl, bvh_walk=counted)
        np.testing.assert_array_equal(rec.hit.numpy(), np.asarray(ref.hit))
        hit = np.asarray(ref.hit)
        np.testing.assert_allclose(rec.point.numpy()[hit], np.asarray(ref.point)[hit],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(rec.material.numpy(), np.asarray(ref.material))
    assert len(calls) == 3


def test_diff_route_recomputes_t_with_gradients(mesh_path):
    _, ts, _ = _scenes("mesh", mesh_path)
    org, dirn = _rays(128, 3.0, 4)
    o = torch.from_numpy(org).requires_grad_()
    t, prim = traverse.nearest_hit_bvh_diff(ts, o, torch.from_numpy(dirn), 1e-3, 3e38,
                                            CompatConfig())
    t_walk, p_walk = traverse.bvh_walk(ts, torch.from_numpy(org), torch.from_numpy(dirn), 1e-3,
                                       3e38, CompatConfig())
    assert torch.equal(prim, p_walk)
    hit = prim >= 0
    torch.testing.assert_close(t[hit], t_walk[hit], rtol=1e-6, atol=0)
    (t[hit].sum()).backward()
    assert bool(torch.isfinite(o.grad).all()) and float(o.grad.abs().max()) > 0


def test_walk_kernel_needs_a_card(mesh_path):
    _, ts, _ = _scenes("mesh", mesh_path)
    org, dirn = (torch.from_numpy(x) for x in _rays(8, 3.0, 5))
    with pytest.raises(ValueError, match="no kernel"):
        traverse._launch(ts, org, dirn, 1e-3, 3e38, CompatConfig())
